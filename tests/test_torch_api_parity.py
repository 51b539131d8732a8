"""The port's public API against the JAX package's, name by name, on the CPU.

For every module of ``baselines_tpu``, each public function and class that the module
defines, and each public method or property of those classes (inherited ones count),
must have a counterpart of the same name in the port's module of the same path. The
exceptions are listed below, each with its reason: the names the port has under
another name (``RENAMED``), and the JAX idioms that have no PyTorch counterpart
(``LEFT_OUT``). One case per subpackage; each also fails on a stale entry, a listed
name that the JAX package no longer has or that the port has after all.
"""

import importlib
import inspect
import pkgutil

import pytest

import baselines_tpu

SUBPACKAGES = ["core", "envs", "nn", "data", "algos", "distributed", "native", "ops",
               "bench", "examples", "root"]

# the port's module of a JAX module, where the path differs
PORT_MODULE = {"data.pallas_sampler": "ops.stratified_sample"}

# JAX name -> (the port's name, why it differs)
RENAMED = {
    "envs.base.JaxEnv": ("TorchEnv", "the device env interface, named for its framework"),
    "envs.vec.VecJaxEnv": ("VecTorchEnv", "the batched device env, named likewise"),
    "envs.registry.is_jax_env": ("is_torch_env", "whether an id is a device env"),
    "envs.video.jax_env_frame_fn": ("torch_env_frame_fn", "frames of a device env"),
    "envs.video.state_inner": ("base_state", "the port's TimeLimit state is a dataclass "
                               "with .inner, so one function peels it with the vec "
                               "wrappers' states"),
    "envs.video.unwrap_vec_state": ("base_state", "the same function, for the vec "
                                    "wrappers' states"),
    "data.pallas_sampler.pallas_stratified_sample": (
        "stratified_sample", "the Pallas sampler's Hopper counterpart (K3) in ops/"),
}

# JAX name -> why the port has no counterpart
LEFT_OUT = {
    "nn.policy.Policy.init": "flax init: a torch module is built with its params",
    "nn.policy.Policy.apply": "flax apply: the port calls the module, which holds its params",
    "nn.policy.Policy.pd": "takes flax params; the port's step and mode_step build the Pd",
    "algos.acktr.acktr.KfacPolicy.apply": "flax apply, as Policy.apply",
    "algos.acktr.acktr.KfacPolicy.pd": "takes flax params, as Policy.pd",
    "algos.dqn.dqn.QPolicy.init": "flax init: the Q-net is built with its params",
    "algos.acktr.acktr.KfacPolicyNet.init": "flax init: a torch module holds its params",
    "algos.acktr.acktr.KfacPolicyNet.layer_grads": "per-layer grads of a params tree; "
    "the port reads .grad of each layer",
    "algos.acktr.acktr.KfacPolicyNet.set_layer_params": "rebuilds a flax params tree; "
    "the port updates its layers in place",
    "algos.common.adam_optimizer": "an optax chain; the port has ClipAdam",
    "algos.common.apply_updates_lr": "optax updates with a traced learning rate",
    "algos.common.dealias": "copies jit-aliased buffers, a jit idiom",
    "algos.common.jit_init": "builds a train state in one jitted program",
    "core.rng.seed_key": "a threefry key; the port draws from a torch.Generator (Draws)",
    "core.rng.fold_shard": "a threefry key per shard; the port's ShardedDraws draws at the "
    "global shape",
    "core.rng.split_tree": "threefry key splits",
    "distributed.mesh.data_sharding": "a GSPMD sharding; the port runs one rank a card",
    "distributed.mesh.replicate": "GSPMD placement; each rank holds its own copy",
    "distributed.mesh.replicated_sharding": "a GSPMD sharding",
    "distributed.mesh.shard_batch": "GSPMD placement; a rank holds its rows (shard_state)",
    "distributed.mesh.shard_train_state": "GSPMD placement; the port's shard_state",
    "envs.callback_env.CallbackVecEnv.step_result_sds": "jax.ShapeDtypeStruct for "
    "io_callback; the port calls the host directly",
    "ops.gather.take_rows_fast": "an XLA gather on the TPU; K2 (take_rows) takes its place",
}


def _subpackage(name: str) -> str:
    """The subpackage of a module or name under ``baselines_tpu`` ("root" for the
    package's own modules)."""
    first = name.split(".")[0]
    spec = importlib.util.find_spec(f"baselines_tpu.{first}") if first else None
    return first if spec is not None and spec.submodule_search_locations else "root"


def _jax_modules(subpackage: str) -> list:
    names = [""] + [m.name[len("baselines_tpu."):] for m in pkgutil.walk_packages(
        baselines_tpu.__path__, "baselines_tpu.")]
    return sorted(n for n in names if _subpackage(n) == subpackage)


def _methods(cls) -> dict:
    """Public methods and properties of ``cls``, its package bases' too: name -> the
    defining class's name under the package."""
    out = {}
    for base in reversed(cls.__mro__):
        if not base.__module__.startswith("baselines_tpu."):
            continue
        where = f"{base.__module__[len('baselines_tpu.'):]}.{base.__qualname__}"
        for name, value in vars(base).items():
            fn = getattr(value, "fget", None) or getattr(value, "__func__", value)
            if not name.startswith("_") and inspect.isfunction(fn) \
                    and fn.__module__.startswith("baselines_tpu."):
                out[name] = f"{where}.{name}"
    return out


def _defines(cls, name: str) -> bool:
    """Whether ``cls`` or one of its bases in the port defines ``name``."""
    return any(name in vars(base) for base in cls.__mro__
               if base.__module__.startswith("baselines_tpu_torch"))


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_port_has_every_public_name(subpackage):
    modules = _jax_modules(subpackage)
    assert modules, subpackage
    missing, stale, seen = [], [], set()
    for mod in modules:
        jax_mod = importlib.import_module("baselines_tpu" + (f".{mod}" if mod else ""))
        port_name = PORT_MODULE.get(mod, mod)
        port_mod = importlib.import_module(
            "baselines_tpu_torch" + (f".{port_name}" if port_name else ""))
        for name, obj in sorted(vars(jax_mod).items()):
            if name.startswith("_") or not callable(obj) \
                    or getattr(obj, "__module__", None) != jax_mod.__name__:
                continue
            key = f"{mod}.{name}" if mod else name
            seen.add(key)
            port_obj = getattr(port_mod, RENAMED.get(key, (name,))[0], None)
            if key in LEFT_OUT:
                if port_obj is not None:
                    stale.append(key)
                continue
            if port_obj is None:
                missing.append(key)
            elif inspect.isclass(obj):
                for method, where in sorted(_methods(obj).items()):
                    seen.add(where)
                    has = _defines(port_obj, method)
                    if where in LEFT_OUT and has:
                        stale.append(where)
                    elif where not in LEFT_OUT and not has:
                        missing.append(f"{key}.{method} (defined in {where})")
    assert not missing, f"the port lacks {missing}"
    assert not stale, f"listed as left out, but the port has {stale}"
    mine = {k for k in list(LEFT_OUT) + list(RENAMED) if _subpackage(k) == subpackage}
    assert mine <= seen, f"listed but not in the JAX package: {sorted(mine - seen)}"
