"""Algorithm registry (counterpart of baselines_tpu/algos/__init__.py, after
baselines/run.py:154-167's import-by-name discovery).

Every learner of the JAX package is ported: ``ppo2``/``ppo``, ``ppo1``, ``a2c``,
``acktr``, ``acer``, ``deepq``/``dqn``, ``trpo_mpi``/``trpo``, ``ddpg``, ``her`` and
``gail``. A name the JAX package does not know raises ``ValueError``. her and gail have
no defaults module, as in the JAX package.
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
    "acktr": "baselines_tpu_torch.algos.acktr.acktr",
    "acer": "baselines_tpu_torch.algos.acer.acer",
    "gail": "baselines_tpu_torch.algos.gail.gail",
}


def algo_names():
    return sorted(_ALGOS)


def _module_name(alg: str) -> str:
    if alg not in _ALGOS:
        raise ValueError(f"unknown algorithm {alg!r}; known: {algo_names()}")
    return _ALGOS[alg]


def get_learn_function(alg: str):
    return import_module(_module_name(alg)).learn


def get_defaults(alg: str, env_type: str) -> dict:
    """Per-algorithm, per-env-type keywords (run.py:170-176 + <alg>/defaults.py)."""
    name = _module_name(alg).rsplit(".", 1)[0] + ".defaults"
    try:
        mod = import_module(name)
    except ModuleNotFoundError as e:  # her and gail have none, as in the JAX package
        if e.name != name:
            raise
        return {}
    fn = getattr(mod, env_type, None)
    return fn() if fn else {}
