"""The port's DeepMind Atari chain (baselines_tpu_torch/envs/atari.py) on the CPU against
the JAX package's (baselines_tpu/envs/atari.py), over stand-in emulators, since no ALE
is installed:

- the seven cases of tests/test_atari_wrappers.py, each run on both sides' wrappers
  over the same ``FakeALE``: the raw actions, observations, rewards, dones and lives
  after every reset and step, bit for bit;
- ``WarpFrame`` without cv2 against the JAX ``WarpFrame`` (cv2's ``cvtColor`` and
  ``INTER_AREA`` resize) on ALE-sized 210x160x3 frames and on the stand-ins' sizes, bit
  for bit;
- the vec chain (a host pool of the DeepMind chain behind CallbackVecEnv, frame-stacked
  by VecFrameStack) against the JAX package's over an ALE-sized stand-in, 50 steps;
- ppo2 with ``cnn_s2d`` in bf16 on that chain, packed by VecS2D, on the CPU;
- an Atari id with no ale_py installed raises ModuleNotFoundError naming it, as the JAX
  package does, and the chain imports no cv2.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_atari_wrappers import FakeALE
from torch_dist_worker import ReplayDraws

gym = pytest.importorskip("gymnasium")
cv2 = pytest.importorskip("cv2")

from baselines_tpu.envs import atari as jax_atari  # noqa: E402
from baselines_tpu.envs.callback_env import CallbackVecEnv as JaxCallbackVecEnv  # noqa: E402
from baselines_tpu.envs.gym_bridge import HostDummyVecEnv as JaxDummy  # noqa: E402
from baselines_tpu.envs.vec import VecFrameStack as JaxVecFrameStack  # noqa: E402
from baselines_tpu_torch.envs import atari  # noqa: E402


def _noop(m):
    fake = FakeALE(seed=7)
    return m.NoopResetEnv(fake, noop_max=12), fake, ["reset", 0, 0, "reset", 1]


def _max_and_skip(m):
    fake = FakeALE(life_every=10_000)
    return m.MaxAndSkipEnv(fake, skip=4), fake, ["reset", 3, 2, 0, 0, 1]


def _episodic_life(m):
    fake = FakeALE(life_every=5, start_lives=2)
    return m.EpisodicLifeEnv(fake), fake, ["reset"] + [0] * 5 + ["reset"] + [0] * 5 + ["reset"]


def _fire_reset(m):
    fake = FakeALE(life_every=10_000)
    return m.FireResetEnv(fake), fake, ["reset", 3, "reset"]


def _warp_frame(m):
    fake = FakeALE(life_every=10_000)
    return m.WarpFrame(fake), fake, ["reset", 0, 0]


def _clip_reward(m):
    fake = FakeALE(life_every=10_000)
    return m.ClipRewardEnv(fake), fake, ["reset"] + [0] * 15


def _full_chain(m):
    """make_atari + wrap_deepmind's order (atari_wrappers.py:266-289) on a two-life
    game of 100-frame lives, played past its game over with a reset at every done."""
    fake = FakeALE(life_every=100, start_lives=2, seed=3)
    env = m.MaxAndSkipEnv(m.NoopResetEnv(fake, noop_max=6), skip=4)
    env = m.ClipRewardEnv(m.WarpFrame(m.FireResetEnv(m.EpisodicLifeEnv(env))))
    return env, fake, ["reset"] + ["auto"] * 70


CASES = {"noop_reset": _noop, "max_and_skip": _max_and_skip,
         "episodic_life": _episodic_life, "fire_reset": _fire_reset,
         "warp_frame": _warp_frame, "clip_reward": _clip_reward, "full_chain": _full_chain}


def _drive(case, m):
    """Run the case's script on module ``m``'s wrappers: after each op, (obs, reward,
    terminated, truncated, lives, raw frame count, resets); "auto" steps NOOP and
    resets where the step was done."""
    env, fake, script = case(m)
    trace = []

    def record(obs, *step):
        trace.append((obs, *(step or (None,) * 3), fake.lives, fake.t, fake.resets))

    for op in script:
        if op == "reset":
            record(env.reset()[0])
            continue
        obs, rew, term, trunc, _ = env.step(0 if op == "auto" else op)
        record(obs, rew, term, trunc)
        if op == "auto" and (term or trunc):
            record(env.reset()[0])
    return trace, fake.actions


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_case_matches_jax(name):
    """Each case of tests/test_atari_wrappers.py on the port's wrappers steps the
    emulator with the same raw actions and returns the same observations, rewards,
    dones and lives as the JAX package's, bit for bit."""
    ours, our_actions = _drive(CASES[name], atari)
    theirs, their_actions = _drive(CASES[name], jax_atari)
    assert our_actions == their_actions and len(our_actions) > 0
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype
        assert a[1:] == b[1:]
    if name == "full_chain":  # a lost life and a game over, both reset
        assert ours[-1][-1] >= 2 and any(t[4] == 1 for t in ours)


def _frames(n, shape, seed):
    """Random frames, frames of 10x10 blocks, and smooth gradients."""
    rng = np.random.RandomState(seed)
    h, w, _ = shape
    out = [rng.randint(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    out += [np.repeat(np.repeat(rng.randint(0, 256, (-(-h // 10), -(-w // 10), 3), np.uint8),
                                10, 0), 10, 1)[:h, :w] for _ in range(n)]
    yy, xx = np.mgrid[:h, :w]
    out += [np.stack([(yy * (k + 1)) % 256, (xx * (k + 3)) % 256, (yy + xx * k) % 256],
                     -1).astype(np.uint8) for k in range(n)]
    return out


class _Frames:
    """An env whose reset and steps return the given frames in turn."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.i = 0

    def reset(self, **kwargs):
        self.i = 0
        return self.frames[0], {}

    def step(self, action):
        self.i += 1
        return self.frames[self.i], 0.0, False, False, {}


@pytest.mark.parametrize("shape", [(210, 160, 3), (250, 160, 3), (40, 40, 3), (64, 64, 3)])
def test_warp_frame_matches_cv2(shape):
    """The port's numpy WarpFrame against the JAX WarpFrame (cv2 greyscale and
    INTER_AREA resize) on 30 frames, bit for bit: the ALE's 210x160 (both axes shrink by
    2.5 and 1.9), a taller frame, and the stand-ins' 40x40 and 64x64 (both axes grow)."""
    frames = _frames(10, shape, seed=shape[0])
    ours, theirs = atari.WarpFrame(_Frames(frames)), jax_atari.WarpFrame(_Frames(frames))
    got = [ours.reset()[0]] + [ours.step(0)[0] for _ in frames[1:]]
    want = [theirs.reset()[0]] + [theirs.step(0)[0] for _ in frames[1:]]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (84, 84, 1) and g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert ours.observation_space.shape == (84, 84, 1)


class AleStandIn:
    """An ALE-sized emulator: 210x160x3 u8 frames that move with the frame count and
    the actions, Breakout's action meanings, 5 lives lost every 97 frames, rewards on a
    schedule, and ``np_random`` seeded by ``reset(seed=)``, as gymnasium's envs are."""

    def __init__(self):
        self.observation_space = gym.spaces.Box(0, 255, (210, 160, 3), np.uint8)
        self.action_space = gym.spaces.Discrete(4)
        self.np_random = np.random.default_rng(0)
        self.ale = self  # lives() below
        self.t = self.x = 0
        self._lives = 5

    @property
    def unwrapped(self):
        return self

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "RIGHT", "LEFT"]

    def lives(self):
        return self._lives

    def _frame(self):
        f = np.zeros((210, 160, 3), np.uint8)
        f[:, :, 0] = (np.arange(160) * 3 + self.t) % 256
        f[:, :, 1] = ((np.arange(210) * 5)[:, None] + 7 * self.t) % 256
        f[(self.t * 3) % 200:(self.t * 3) % 200 + 10, self.x % 150:self.x % 150 + 10, 2] = 255
        return f

    def reset(self, seed=None, **kwargs):
        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        self.t, self._lives = 0, 5
        self.x = int(self.np_random.integers(0, 150))
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        self.x += {2: 3, 3: -3}.get(int(action), 0)
        if self.t % 97 == 0:
            self._lives -= 1
        reward = 1.0 if self.t % 7 == 0 else (-1.0 if self.t % 31 == 0 else 0.0)
        return self._frame(), reward, self._lives == 0, False, {}

    def render(self):
        return self._frame()

    def close(self):
        pass


def _chain(m):
    """make_atari's and wrap_deepmind's wrappers of module ``m`` over AleStandIn."""
    env = m.MaxAndSkipEnv(m.NoopResetEnv(AleStandIn(), noop_max=30), skip=4)
    return m.wrap_deepmind(env)


def _port_chain():
    return _chain(atari)


def _jax_chain():
    return _chain(jax_atari)


def test_vec_chain_matches_jax():
    """The port's host pool (worker processes) of the DeepMind chain behind
    CallbackVecEnv and VecFrameStack(4) against the JAX package's HostDummyVecEnv ->
    CallbackVecEnv -> VecFrameStack over the same stand-in, from the JAX side's reset
    seed: the stacked u8 observations, rewards and dones of 50 steps of random actions,
    bit for bit, over lost lives and their episodic resets."""
    n = 4
    ours = atari.atari_vec_env(_port_chain, n, 4, device="cpu")
    theirs = JaxVecFrameStack(JaxCallbackVecEnv(JaxDummy([_jax_chain] * n)), 4)
    try:
        key = jax.random.PRNGKey(5)
        jobs, jstate = theirs.reset(key)
        draws = ReplayDraws()
        draws.push("randint", jax.random.randint(key, (), 0, 2**31 - 1))
        tobs, tstate = ours.reset(draws)
        assert not draws.queue
        assert tobs.dtype == torch.uint8 and tuple(tobs.shape) == (n, 84, 84, 4)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        dones = 0
        for a in np.random.RandomState(0).randint(0, 4, size=(50, n)):
            jobs, jstate, jrew, jdone, _ = theirs.step(key, jstate, jnp.asarray(a, jnp.int32))
            tobs, tstate, trew, tdone, _ = ours.step(None, tstate, torch.from_numpy(a))
            np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
            np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
            dones += int(tdone.sum())
        assert dones > 0
    finally:
        ours.close()


def test_ppo2_cnn_s2d_on_the_chain():
    """ppo2 with cnn_s2d in bf16 on the chain packed by VecS2D(4) (21x21x64 frames), two
    updates of 4 envs x 16 steps on the CPU: finite params that moved, and the monitor
    counting the stand-in's episodes."""
    from baselines_tpu_torch.algos.ppo import ppo
    from baselines_tpu_torch.envs.vec import VecMonitor, VecS2D

    venv = VecS2D(VecMonitor(atari.atari_vec_env(_port_chain, 4, 4, device="cpu")), 4)
    try:
        model = ppo.learn(env=venv, network="cnn_s2d", dtype=torch.bfloat16, seed=0,
                          nsteps=16, nminibatches=2, noptepochs=2, total_timesteps=128,
                          log_interval=1, device="cpu")
    finally:
        venv.close()
    assert tuple(model.state.obs.shape) == (4, 21, 21, 64)
    assert all(torch.isfinite(p).all() for p in model.policy.module.parameters())
    assert int(model.state.update_idx) == 2


def test_atari_id_without_ale_py_raises_and_chain_imports_no_cv2():
    """build_env on an Atari id raises ModuleNotFoundError naming ale_py where it is
    missing, before a worker starts; the port's chain runs in a process where cv2 cannot
    be imported."""
    from baselines_tpu_torch.algos.common import build_env

    try:
        import ale_py  # noqa: F401
        pytest.skip("ale_py is installed")
    except ModuleNotFoundError:
        pass
    with pytest.raises(ModuleNotFoundError, match="ale_py"):
        build_env("BreakoutNoFrameskip-v4", 2, device="cpu")
    code = ("import sys\nsys.modules['cv2'] = None\n"
            "import numpy as np\n"
            "from baselines_tpu_torch.envs.atari import WarpFrame, rgb_to_gray, resize_area\n"
            "f = np.zeros((210, 160, 3), np.uint8)\n"
            "print(resize_area(rgb_to_gray(f), 84, 84).shape)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr
    assert "(84, 84)" in proc.stdout
