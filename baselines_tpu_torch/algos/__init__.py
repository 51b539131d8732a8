"""Algorithm registry (counterpart of baselines_tpu/algos/__init__.py, after
baselines/run.py:154-167's import-by-name discovery).

``ppo2``/``ppo``, ``ppo1``, ``a2c``, ``deepq``/``dqn``, ``trpo_mpi``/``trpo``, ``ddpg`` and
``her`` are ported. Every other
algorithm the JAX package knows raises ``NotImplementedError`` naming the item of
ROADMAP.md's Queue 1 that brings it; a name the JAX package does not know raises
``ValueError``.
"""

from importlib import import_module

_ALGOS = {
    "ppo2": "baselines_tpu_torch.algos.ppo.ppo",
    "ppo": "baselines_tpu_torch.algos.ppo.ppo",
    "ppo1": "baselines_tpu_torch.algos.ppo1.ppo1",
    "a2c": "baselines_tpu_torch.algos.a2c.a2c",
    "deepq": "baselines_tpu_torch.algos.dqn.dqn",
    "dqn": "baselines_tpu_torch.algos.dqn.dqn",
    "trpo_mpi": "baselines_tpu_torch.algos.trpo.trpo",
    "trpo": "baselines_tpu_torch.algos.trpo.trpo",
    "ddpg": "baselines_tpu_torch.algos.ddpg.ddpg",
    "her": "baselines_tpu_torch.algos.her.her",
}
_NOT_PORTED = {name: "item 7" for name in ("acktr", "acer", "gail")}


def algo_names():
    return sorted(_ALGOS)


def _module_name(alg: str) -> str:
    if alg in _NOT_PORTED:
        raise NotImplementedError(f"{alg} is not ported yet; it comes with {_NOT_PORTED[alg]} "
                                  "of ROADMAP.md's Queue 1")
    if alg not in _ALGOS:
        known = sorted(set(_ALGOS) | set(_NOT_PORTED))
        raise ValueError(f"unknown algorithm {alg!r}; known: {known}")
    return _ALGOS[alg]


def get_learn_function(alg: str):
    return import_module(_module_name(alg)).learn


def get_defaults(alg: str, env_type: str) -> dict:
    """Per-algorithm, per-env-type keywords (run.py:170-176 + <alg>/defaults.py)."""
    name = _module_name(alg).rsplit(".", 1)[0] + ".defaults"
    try:
        mod = import_module(name)
    except ModuleNotFoundError as e:  # her has none, as in the JAX package
        if e.name != name:
            raise
        return {}
    fn = getattr(mod, env_type, None)
    return fn() if fn else {}
