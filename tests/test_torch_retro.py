"""The port's retro wrappers (baselines_tpu_torch/envs/retro_wrappers.py) on the CPU
against the JAX package's (baselines_tpu/envs/retro_wrappers.py), over the stand-ins of
tests/test_retro_wrappers.py, since no retro emulator is installed: each case of that
file runs the same script on both sides' wrappers, and the observations, rewards,
dones, the raw actions the emulator took and its movie settings agree bit for bit, the
numpy ``RandomState`` draws included. Also: the spaces the port declares are its own,
and ``--gamestate`` reaches a retro chain only through ``make_retro_vec_env``, which
raises ModuleNotFoundError naming retro where it is missing."""

import numpy as np
import pytest
from test_retro_wrappers import FakeRetro, FakeRetroSpaces

from baselines_tpu.envs import retro_wrappers as jax_retro
from baselines_tpu_torch.envs import retro_wrappers as retro
from baselines_tpu_torch.envs.spaces import Box, DictSpace, Discrete


class _Recording(FakeRetroSpaces):
    """FakeRetroSpaces that records the raw actions as given (SonicDiscretizer's
    button arrays)."""

    def step(self, action):
        self.actions.append(np.array(action))
        self.t += 1
        return self._obs(), 0.0, False, False, {}


def _spaces(seed=11, **kwargs):
    env = FakeRetroSpaces(**kwargs)
    env.action_space.seed(seed)  # the random actions' sampler, alike on both sides
    return env


# name -> function of the module giving [(wrapped env, raw env, script), ...]
CASES = {
    "frameskip_accumulates": lambda m: [
        (m.StochasticFrameSkip(e := FakeRetro(), n=4, stickprob=0.0, seed=0), e,
         ["reset", 7])],
    "frameskip_stickprob_zero": lambda m: [
        (m.StochasticFrameSkip(e := FakeRetro(), n=2, stickprob=0.0, seed=0), e,
         ["reset", 1, 2, 3])],
    "frameskip_stickprob_one": lambda m: [
        (m.StochasticFrameSkip(e := FakeRetro(), n=3, stickprob=1.0, seed=0), e,
         ["reset", 1, 2, 3])],
    "frameskip_stickprob_half": lambda m: [
        (m.StochasticFrameSkip(e := FakeRetro(), n=4, stickprob=0.5, seed=5), e,
         ["reset"] + [k % 5 for k in range(40)])],
    "frameskip_breaks_on_termination": lambda m: [
        (m.StochasticFrameSkip(e := FakeRetro(horizon=2), n=4, stickprob=0.0, seed=0), e,
         ["reset", 0])],
    "frameskip_reset_clears": lambda m: [
        (m.StochasticFrameSkip(e := FakeRetro(), n=1, stickprob=1.0, seed=0), e,
         ["reset", 5, "reset", 9])],
    "downsample_and_rgb2gray": lambda m: [
        (m.Downsample(e := FakeRetro(), ratio=2), e, ["reset", 0, 0]),
        (m.Rgb2gray(e2 := FakeRetro()), e2, ["reset", 0, 0])],
    "reward_scaler": lambda m: [
        (m.RewardScaler(e := FakeRetro(), scale=0.01), e, ["reset", 0, 0])],
    "wrap_deepmind_retro": lambda m: [
        (m.wrap_deepmind_retro(e := FakeRetro()), e, ["reset", 0, 1]),
        (m.wrap_deepmind_retro(m.RewardScaler(e2 := FakeRetro(), 0.01)), e2, ["reset", 0])],
    "partial_frame_stack": lambda m: [
        (m.PartialFrameStack(e := FakeRetroSpaces(), k=3, channel=1), e,
         ["reset", 0, 0, 0])],
    "movie_record": lambda m: [
        (m.MovieRecord(e := FakeRetroSpaces(horizon=3), savedir="/movies", k=2), e,
         ["reset", "reset", "reset", 0])],
    "append_timeout": lambda m: [
        (m.AppendTimeout(e := FakeRetroSpaces(horizon=10)), e, ["reset"] + [0] * 5)],
    "start_random_actions": lambda m: [
        (m.StartDoingRandomActionsWrapper(e := _spaces(), max_random_steps=8, seed=3), e,
         ["reset", 2, 1])],
    "start_random_actions_every_episode": lambda m: [
        (m.StartDoingRandomActionsWrapper(e := _spaces(horizon=2), max_random_steps=5,
                                          every_episode=True, seed=0), e,
         ["reset"] + [1] * 6)],
    "sonic_discretizer": lambda m: [
        (m.SonicDiscretizer(e := _Recording()), e, list(range(7)))],
    "allow_backtracking": lambda m: [
        (m.AllowBacktracking(e := FakeRetroSpaces(rewards=[1.0, 2.0, -3.0, 1.0, 3.0])), e,
         ["reset"] + [0] * 10)],
}


def _drive(pairs):
    """Each (env, raw, script): after each op its result, the raw step count, the raw
    actions so far and the emulator's movie settings."""
    trace = []
    for env, raw, script in pairs:
        for op in script:
            out = env.reset()[:1] if op == "reset" else env.step(op)[:-1]
            trace.append((out, raw.t,
                          [np.asarray(a).tolist() for a in raw.actions],
                          getattr(raw, "movie_path", "-"), getattr(raw, "movie", "-")))
    return trace


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_retro_case_matches_jax(name):
    """The case on the port's wrappers and on the JAX package's, bit for bit."""
    ours, theirs = _drive(CASES[name](retro)), _drive(CASES[name](jax_retro))
    assert len(ours) == len(theirs) > 0
    _same(ours, theirs)


def test_declared_spaces_are_the_ports():
    """PartialFrameStack, AppendTimeout and SonicDiscretizer declare the port's spaces
    (the JAX package's declare gymnasium's), of the same shapes and keys."""
    pfs = retro.PartialFrameStack(FakeRetroSpaces(), k=3)
    assert isinstance(pfs.observation_space, Box) and pfs.observation_space.shape == (64, 64, 5)
    at = retro.AppendTimeout(FakeRetroSpaces(horizon=10))
    assert isinstance(at.observation_space, DictSpace)
    jat = jax_retro.AppendTimeout(FakeRetroSpaces(horizon=10))
    assert sorted(at.observation_space.spaces) == sorted(jat.observation_space.spaces)
    sd = retro.SonicDiscretizer(FakeRetroSpaces())
    assert sd.action_space == Discrete(7)


def test_retro_chain_needs_retro():
    """make_retro_vec_env raises ModuleNotFoundError naming retro before a worker
    starts, where retro is missing."""
    try:
        import retro as _retro  # noqa: F401
        pytest.skip("retro is installed")
    except ModuleNotFoundError:
        pass
    with pytest.raises(ModuleNotFoundError, match="retro"):
        retro.make_retro_vec_env("SonicTheHedgehog-Genesis", 2, gamestate="GreenHillZone.Act1",
                                 device="cpu")
