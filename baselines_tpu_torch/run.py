"""CLI entry point: ``python -m baselines_tpu_torch.run --alg=ppo2 --env=CartPole-v1``
(counterpart of baselines_tpu/run.py, after baselines/run.py:202-250).

Env-type detection, per-algorithm defaults by env type, free-form ``--key=value``
keywords over the defaults (an explicit ``--network`` beats them), ``--num_env``,
``--s2d``, ``--reward_scale``, ``--env_kwargs`` (for example ``"{'normalize': True}"``),
``--save_path`` / ``--load_path``, ``--log_path`` and a ``--play`` report after
training, under the model's VecNormalize statistics when it has them. The learners run
on the card unless ``--device=cpu`` is given, a free-form keyword that reaches
``learn``. ``--save_video_interval`` and ``--gamestate`` raise ``NotImplementedError``
naming the item of ROADMAP.md's Queue 1 that brings them.
"""

from __future__ import annotations

import os.path as osp
import sys

from baselines_tpu_torch import algos
from baselines_tpu_torch.algos.common import build_env, evaluate
from baselines_tpu_torch.cmd_util import common_arg_parser, parse_cmdline_kwargs
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.envs.registry import get_env_type

PLAY_STEPS = 2000


def _default_network(env_type: str) -> str:
    """run.py:145-152: cnn for image envs, mlp otherwise."""
    return "cnn" if env_type in ("atari", "retro") else "mlp"


def _reject_unported_env_flags(args) -> None:
    for given, flag, item in (
        (args.save_video_interval, "--save_video_interval", "item 8 (envs/video.py)"),
        (args.gamestate, "--gamestate", "item 8 (the retro envs)"),
    ):
        if given:
            raise NotImplementedError(f"{flag} is not ported yet; it comes with {item} of "
                                      "ROADMAP.md's Queue 1")


def train(args, extra_args):
    _reject_unported_env_flags(args)
    env_type = args.env_type or get_env_type(args.env)
    logger.log(f"env_type: {env_type}")
    learn = algos.get_learn_function(args.alg)
    alg_kwargs = dict(algos.get_defaults(args.alg, env_type))
    alg_kwargs.update(extra_args)
    if args.network:
        alg_kwargs["network"] = args.network
    else:
        alg_kwargs.setdefault("network", _default_network(env_type))
    if args.num_env:
        alg_kwargs["num_env"] = args.num_env
    if "num_env" in alg_kwargs:  # the learners take num_envs
        alg_kwargs["num_envs"] = alg_kwargs.pop("num_env")

    env_kwargs = dict(alg_kwargs.pop("env_kwargs", None) or {})
    # --s2d=4 packs the frames 4x4 space-to-depth; only cnn_s2d's conv1 matches the
    # packing, so cnn turns into it and any other network is refused
    s2d = int(alg_kwargs.pop("s2d", 0) or 0)
    if s2d:
        env_kwargs["s2d"] = s2d
        net = alg_kwargs.get("network")
        if net == "cnn":
            alg_kwargs["network"] = "cnn_s2d"
        elif net != "cnn_s2d":
            raise ValueError(f"--s2d only pairs with network=cnn/cnn_s2d, got {net!r}")
    if args.reward_scale != 1.0:
        env_kwargs["reward_scale"] = args.reward_scale

    logger.log(f"Training {args.alg} on {args.env} with arguments \n{alg_kwargs}")
    return learn(env_id=args.env, seed=args.seed, total_timesteps=int(args.num_timesteps),
                 load_path=args.load_path, env_kwargs=env_kwargs or None, **alg_kwargs)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args, unknown_args = common_arg_parser().parse_known_args(argv)
    extra_args = parse_cmdline_kwargs(unknown_args)
    logger.configure(dir=args.log_path)

    model = train(args, extra_args)

    if args.save_path is not None:
        save_path = osp.expanduser(args.save_path)
        model.save(save_path)
        logger.log(f"Saved model to {save_path}")

    if args.play:
        logger.log("Running trained model")
        # one env on the model's device, stepped deterministically for a bounded number
        # of steps (the reference loops until interrupted); normalized only when the
        # model carries trained statistics, which evaluate starts the env from
        device = model.device
        venv = build_env(args.env, 1, device=device,
                         normalize=model._normalize_state() is not None,
                         frame_stack=int(extra_args.get("frame_stack", 0) or 0),
                         s2d=int(extra_args.get("s2d", 0) or 0))
        ret, length, episodes = evaluate(model, venv, Draws(0, device), nsteps=PLAY_STEPS,
                                         deterministic=True)
        logger.log(f"episode_rew mean={ret} len={length} episodes={episodes}")

    return model


if __name__ == "__main__":
    main()
