"""CLI argument surface (a copy of baselines_tpu/cmd_util.py, after
baselines/common/cmd_util.py).

`common_arg_parser` mirrors cmd_util.py:155-174's flag set;
`parse_unknown_args` + `parse_cmdline_kwargs` reproduce the free-form
`--key=value` kwargs pipe (run.py:180-192) that merges arbitrary
hyperparameters over the per-alg defaults.
"""

from __future__ import annotations

import argparse


def arg_parser():
    return argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )


def common_arg_parser():
    """cmd_util.py:155-174."""
    parser = arg_parser()
    parser.add_argument("--env", help="environment ID", type=str, default="CartPole-v1")
    parser.add_argument(
        "--env_type",
        help="type of environment, used when it cannot be automatically determined",
        type=str,
    )
    parser.add_argument("--seed", help="RNG seed", type=int, default=None)
    parser.add_argument("--alg", help="Algorithm", type=str, default="ppo2")
    parser.add_argument("--num_timesteps", type=float, default=1e6)
    parser.add_argument(
        "--network",
        help="network type (mlp, cnn, lstm, cnn_lstm, conv_only)",
        default=None,
    )
    parser.add_argument(
        "--num_env",
        help="Number of parallel environment copies (default per env type)",
        default=None,
        type=int,
    )
    parser.add_argument("--reward_scale", help="Reward scale factor", default=1.0, type=float)
    parser.add_argument(
        "--gamestate", help="game state to load (so far only used in retro games)", default=None
    )
    parser.add_argument(
        "--save_video_interval",
        help="Save video every x steps (0 = disabled)",
        default=0,
        type=int,
    )
    parser.add_argument(
        "--save_video_length",
        help="Length of recorded video. Default: 200",
        default=200,
        type=int,
    )
    parser.add_argument("--save_path", help="Path to save trained model to", default=None, type=str)
    parser.add_argument("--load_path", help="Path to load trained model from", default=None, type=str)
    parser.add_argument("--log_path", help="Directory to save learning curve data", default=None, type=str)
    parser.add_argument("--play", default=False, action="store_true")
    return parser


def parse_unknown_args(args):
    """--key=value / --key value pairs → dict of strings (cmd_util.py:187-206)."""
    retval = {}
    preceded_by_key = False
    key = None
    for arg in args:
        if arg.startswith("--"):
            if "=" in arg:
                k, v = arg.split("=", 1)
                retval[k[2:]] = v
                preceded_by_key = False
            else:
                key = arg[2:]
                preceded_by_key = True
        elif preceded_by_key:
            retval[key] = arg
            preceded_by_key = False
    return retval


def parse_cmdline_kwargs(args):
    """eval() each value into a python object when possible (run.py:180-192)."""

    def parse(v):
        assert isinstance(v, str)
        try:
            return eval(v)
        except (NameError, SyntaxError):
            return v

    return {k: parse(v) for k, v in parse_unknown_args(args).items()}
