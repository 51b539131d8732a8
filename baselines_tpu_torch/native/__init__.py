"""The native (C++/OpenMP) batched env engine (counterpart of baselines_tpu/native).

``NativeVecEnv`` serves the host vec env interface (``reset(seed)``, ``step``,
``step_async``/``step_wait``) on ``csrc/envpool.cpp``: the whole batch steps in one C
call, OpenMP-parallel over the envs from 64 envs on, so the host side of a step is one
function call. ``envs/callback_env.py`` puts it behind the port's vec interface, and the
``native:`` env ids (``native:CartPole-v1``) select it in ``algos.common.build_env``.

The source is the JAX package's, with one addition: ``btenv_create`` takes the global
index of the pool's first env (``first_env``), which seeds env i's generator as env
``first_env + i`` of one pool, so that a rank of a mesh steps its rows of the
one-process batch. With ``first_env=0`` the two engines step bit for bit alike.
It is compiled with g++ at first use into ``baselines_tpu_torch/_build/``, under a name
keyed by the source's hash. A build or load that fails raises with the compiler's
error: no id falls back to another engine.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from baselines_tpu_torch.envs.registry import make_env

SOURCE = Path(__file__).resolve().parent / "csrc" / "envpool.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

NATIVE_ENV_IDS = (
    "CartPole-v0",
    "CartPole-v1",
    "Pendulum-v1",
    "MountainCar-v0",
    "MountainCarContinuous-v0",
    "Acrobot-v1",
)

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"envpool_{tag}.so"


def build() -> Path:
    """Compile the engine unless it is built; returns the library's path. Raises
    RuntimeError with the compiler's output when the compiler cannot be run or fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native env engine cannot be built: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the native env engine failed to build ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic, so processes building at once do not clash
    return path


def library():
    """The loaded engine, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.btenv_create.restype = ctypes.c_void_p
        lib.btenv_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                                      ctypes.c_uint64]
        lib.btenv_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("btenv_obs_dim", "btenv_act_dim", "btenv_n_actions", "btenv_state_dim",
                   "btenv_max_steps"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.btenv_reset.argtypes = [ctypes.c_void_p, f32p]
        lib.btenv_step.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, u8p, f32p]
        lib.btenv_get_state.argtypes = [ctypes.c_void_p, f64p]
        lib.btenv_set_state.argtypes = [ctypes.c_void_p, f64p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the engine builds and loads here (native/__init__.py:86-87). A query only:
    ``NativeVecEnv`` and ``build_env`` still raise with the compiler's error where it
    does not."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def supports(env_id: str) -> bool:
    """Whether the engine serves ``env_id`` here (native/__init__.py:90-91)."""
    return env_id in NATIVE_ENV_IDS and available()


class NativeVecEnv:
    """A batch of ``num_envs`` native envs behind the host vec env interface, one C call
    a step (native/__init__.py:97-198). The spaces are those of the port's device env
    of the same id. ``first_env`` is the global index of the batch's first env, nonzero
    for a rank of a mesh."""

    def __init__(self, env_id: str, num_envs: int, seed: int = 0, first_env: int = 0):
        if env_id not in NATIVE_ENV_IDS:
            raise ValueError(f"the native engine does not implement {env_id!r}; it has "
                             f"{list(NATIVE_ENV_IDS)}")
        self._lib = library()
        self.env_id = env_id
        self.num_envs = int(num_envs)
        self.first_env = int(first_env)
        self._handle = self._lib.btenv_create(env_id.encode(), self.num_envs, seed,
                                              self.first_env)
        self._obs_dim = self._lib.btenv_obs_dim(self._handle)
        self._act_dim = self._lib.btenv_act_dim(self._handle)
        self.state_dim = self._lib.btenv_state_dim(self._handle)
        self.max_steps = self._lib.btenv_max_steps(self._handle)
        spaces = make_env(env_id)
        self.observation_space = spaces.observation_space
        self.action_space = spaces.action_space
        n, od = self.num_envs, self._obs_dim
        self._obs = np.empty((n, od), np.float32)
        self._rew = np.empty((n,), np.float32)
        self._done = np.empty((n,), np.uint8)
        self._terminal_obs = np.empty((n, od), np.float32)
        self._pool = None
        self._pending = None

    def reset(self, seed=None):
        """Reset every env; a ``seed`` makes the batch anew from it, so that the same
        seed gives the same episodes."""
        if seed is not None:
            self._lib.btenv_destroy(self._handle)
            self._handle = self._lib.btenv_create(self.env_id.encode(), self.num_envs,
                                                  int(seed), self.first_env)
        self._lib.btenv_reset(self._handle, self._obs)
        return self._obs.copy()

    def _actions(self, actions) -> np.ndarray:
        return np.ascontiguousarray(np.reshape(np.asarray(actions, np.float32),
                                               (self.num_envs, self._act_dim)))

    def step_async(self, actions) -> None:
        """Start the batch's step on a worker thread; ctypes releases the GIL for the
        C call, so the envs step while the caller computes (the step_async/step_wait
        split of subproc_vec_env.py:75-88 without the processes)."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending = self._pool.submit(self._lib.btenv_step, self._handle,
                                          self._actions(actions), self._obs, self._rew,
                                          self._done, self._terminal_obs)

    def step_wait(self):
        pending, self._pending = self._pending, None
        pending.result()
        return self._collect()

    def step(self, actions):
        self._lib.btenv_step(self._handle, self._actions(actions), self._obs, self._rew,
                             self._done, self._terminal_obs)
        return self._collect()

    def _collect(self):
        """(obs, rewards, dones, infos), each env's info holding its terminal
        observation where it was done, copied: the next step overwrites the buffers."""
        done = self._done.astype(bool)
        infos = [{"terminal_observation": self._terminal_obs[i].copy()} if done[i] else {}
                 for i in range(self.num_envs)]
        return self._obs.copy(), self._rew.copy(), done, infos

    def get_state(self) -> np.ndarray:
        """The physics state of every env, (num_envs, state_dim) f64."""
        out = np.empty((self.num_envs, self.state_dim), np.float64)
        self._lib.btenv_get_state(self._handle, out)
        return out

    def set_state(self, state: np.ndarray) -> None:
        s = np.ascontiguousarray(np.asarray(state, np.float64))
        if s.shape != (self.num_envs, self.state_dim):
            raise ValueError(f"state of shape {s.shape}, expected "
                             f"{(self.num_envs, self.state_dim)}")
        self._lib.btenv_set_state(self._handle, s)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._handle:
            self._lib.btenv_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
