"""The port's registries and extension points against the JAX package's on the CPU:
``core.registry.Registry``, ``networks.register`` and ``get_network`` with a name, a
callable or a module, ``register_env`` with ``get_env_type``, the subpackages' exports,
and ``value_network="copy"`` with a factory (two towers of their own weights) or a
module (refused: one torch module cannot be two towers, where a flax module applied to
two sets of params can).

Each test registers names of its own (``registry_test_*``), and the ``fresh_registries``
fixture takes every registration of a test back when it ends: a registry lives as long
as the worker process, and a later test file (``test_torch_cartpole.py``) walks every
registered env id. ``pytest -p no:randomly tests/test_torch_registry.py
tests/test_torch_cartpole.py`` runs the two files in the order that showed it.
"""

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn as nn

import baselines_tpu.core as jax_core
import baselines_tpu.data as jax_data
import baselines_tpu.envs as jax_envs
import baselines_tpu.nn as jax_nn
import baselines_tpu.ops as jax_ops
from baselines_tpu.core.registry import Registry as JaxRegistry
from baselines_tpu.envs import registry as jax_env_registry
from baselines_tpu.envs.classic.cartpole import make_cartpole as jax_make_cartpole
from baselines_tpu.nn import networks as jax_networks
import baselines_tpu_torch.core as core
import baselines_tpu_torch.data as data
import baselines_tpu_torch.envs as envs
import baselines_tpu_torch.nn as tnn
import baselines_tpu_torch.ops as ops
from baselines_tpu_torch.core.registry import Registry
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.envs import registry as env_registry
from baselines_tpu_torch.envs.classic.cartpole import make_cartpole
from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.nn import networks
from baselines_tpu_torch.nn.policy import build_policy

# the port's names for the JAX package's, where they differ
PORT_NAME = {"JaxEnv": "TorchEnv", "VecJaxEnv": "VecTorchEnv"}


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    """Each test registers into copies of both packages' env and network registries
    (and the JAX env registry's type table), which are dropped when it ends."""
    for registry in (env_registry._ENVS, networks._NETWORKS, jax_env_registry._ENVS,
                     jax_networks._NETWORKS):
        monkeypatch.setattr(registry, "_entries", dict(registry._entries))
    monkeypatch.setattr(jax_env_registry, "_ENV_TYPES", dict(jax_env_registry._ENV_TYPES))


class TinyNet(nn.Module):
    """A network that keeps the registry's contract: ``ob_shape``, ``generator`` and its
    own keyword, ``latent_size`` and ``is_recurrent``."""

    is_recurrent = False

    def __init__(self, ob_shape, width: int = 4, generator=None):
        super().__init__()
        self.latent_size = width
        self.Dense_0 = nn.Linear(int(np.prod(ob_shape)), width)
        nn.init.normal_(self.Dense_0.weight, generator=generator)

    def forward(self, x):
        return torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class JaxTinyNet(fnn.Module):
    width: int = 4

    is_recurrent = False

    @fnn.compact
    def __call__(self, x):
        return fnn.relu(fnn.Dense(self.width)(x.reshape((x.shape[0], -1))))


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_registry_matches_jax():
    """The same registrations give the same names; a duplicate and an unknown name raise
    ValueError with the JAX registry's messages; ``register`` returns what it took."""
    port, ref = Registry("widget"), JaxRegistry("widget")
    for name in ("b", "a", "c"):
        obj = object()
        assert port.register(name)(obj) is obj
        ref.register(name)(obj)
    assert port.names() == ref.names() == ["a", "b", "c"]
    assert ("a" in port) and ("z" not in port)
    assert port.get("b") is ref.get("b")
    assert _error(lambda: port.register("a")(1)) == _error(lambda: ref.register("a")(1))
    assert _error(lambda: port.get("z")) == _error(lambda: ref.get("z"))
    assert _error(lambda: port.get("z")) == "unknown widget 'z'; registered: a, b, c"


def test_network_names_cover_the_jax_package():
    """Every name of the JAX package's zoo is registered in the port and none more (names
    that tests or examples register are left out on both sides)."""
    def zoo(names):
        return {n for n in names if not n.startswith(("registry_test", "my_tiny"))}

    assert zoo(networks.network_names()) == zoo(jax_networks.network_names())
    assert len(zoo(networks.network_names())) == 11
    assert networks.network_names() == sorted(networks.network_names())


def test_unknown_network_raises_value_error_as_jax():
    port = _error(lambda: networks.get_network("registry_test_nope", ob_shape=(4,)))
    ref = _error(lambda: jax_networks.get_network("registry_test_nope"))
    assert port.split(";")[0] == ref.split(";")[0] == \
        "unknown network 'registry_test_nope'"
    assert "mlp" in port and "cnn_s2d" in port


def test_register_and_get_network_by_name_callable_and_module():
    """``register`` adds a network that ``get_network`` builds by name with the port's
    keywords; a callable is called with them; a module comes back as it is; a second
    registration raises ValueError; the JAX package does each of these alike."""
    assert networks.register("registry_test_net")(TinyNet) is TinyNet
    jax_networks.register("registry_test_net")(JaxTinyNet)
    gen = torch.Generator().manual_seed(0)
    by_name = networks.get_network("registry_test_net", ob_shape=(2, 3), width=5,
                                   generator=gen)
    assert isinstance(by_name, TinyNet) and by_name.latent_size == 5
    assert by_name(torch.ones((7, 2, 3))).shape == (7, 5)
    ref = jax_networks.get_network("registry_test_net", width=5)
    assert isinstance(ref, JaxTinyNet) and ref.width == 5

    calls = []

    def factory(dtype, **kwargs):
        calls.append(dict(kwargs, dtype=dtype))
        return TinyNet(**kwargs)

    built = networks.get_network(factory, ob_shape=(3,), width=2, dtype="float32")
    assert isinstance(built, TinyNet)
    assert calls == [{"ob_shape": (3,), "width": 2, "dtype": torch.float32}]
    jax_calls = []
    jax_networks.get_network(lambda **kw: jax_calls.append(kw) or JaxTinyNet(**kw), width=2)
    assert jax_calls == [{"width": 2}]

    module = TinyNet((3,))
    assert networks.get_network(module, ob_shape=(9,), width=8) is module
    jmodule = JaxTinyNet()
    assert jax_networks.get_network(jmodule, width=8) is jmodule

    port_dup = _error(lambda: networks.register("registry_test_net")(TinyNet))
    jax_dup = _error(lambda: jax_networks.register("registry_test_net")(JaxTinyNet))
    assert port_dup == jax_dup == "duplicate network registration: 'registry_test_net'"


def test_register_env_and_its_type():
    """``register_env`` with a new id: ``make_env`` builds it, ``get_env_type`` gives the
    type it was registered with (``classic_control`` by default), ``is_torch_env`` and
    ``env_names`` know it; a second registration raises ValueError; the JAX package's
    registry agrees on each."""
    ids = {"registry_test_Pole-v0": None, "registry_test_Fixture-v0": "testing"}
    for env_id, env_type in ids.items():
        args = () if env_type is None else (env_type,)
        factory = lambda: make_cartpole(1)  # noqa: E731
        assert envs.register_env(env_id, *args)(factory) is factory
        jax_envs.register_env(env_id, *args)(lambda: jax_make_cartpole(1))
        assert env_registry.get_env_type(env_id) == jax_env_registry.get_env_type(env_id) \
            == (env_type or "classic_control")
        assert env_registry.is_torch_env(env_id) and jax_env_registry.is_jax_env(env_id)
        assert env_id in envs.env_names()
        env = envs.make_env(env_id)
        obs, _ = env.reset(Draws(0, "cpu"), 3, "cpu")
        assert obs.shape == (3, 4)
        assert _error(lambda: envs.register_env(env_id)(factory)) == \
            _error(lambda: jax_envs.register_env(env_id)(factory))
    assert env_registry.get_env_type("native:registry_test_Fixture-v0") == "testing"
    assert envs.env_names() == jax_envs.env_names()


def test_registrations_end_with_their_test():
    """The ids and the network the tests above registered are gone again, on both
    sides."""
    for env_id in ("registry_test_Pole-v0", "registry_test_Fixture-v0"):
        assert not env_registry.is_torch_env(env_id)
        assert not jax_env_registry.is_jax_env(env_id)
        assert env_registry.get_env_type(env_id) == jax_env_registry.get_env_type(env_id) \
            == "classic_control"
    assert "registry_test_net" not in networks.network_names()
    assert "registry_test_net" not in jax_networks.network_names()


def test_failed_duplicate_registration_keeps_the_type():
    """A second ``register_env`` of an id raises ValueError on both sides, and the port
    keeps the type of the first registration. The JAX package records the new type
    before its registry refuses the id (registry.py:20-22), so its ``get_env_type``
    reports the type of the refused registration: a deliberate difference."""
    env_id = "registry_test_Dup-v0"
    envs.register_env(env_id, "testing")(lambda: make_cartpole(1))
    jax_envs.register_env(env_id, "testing")(lambda: jax_make_cartpole(1))
    for register in (envs.register_env, jax_envs.register_env):
        with pytest.raises(ValueError, match="duplicate env registration"):
            register(env_id, "mujoco")(lambda: None)
    assert env_registry.get_env_type(env_id) == "testing"
    assert jax_env_registry.get_env_type(env_id) == "mujoco"


@pytest.mark.parametrize("pkg", ["core", "nn", "envs", "data", "ops"])
def test_subpackage_exports_match_jax(pkg):
    """Every name that ``baselines_tpu.<pkg>`` exports has its counterpart in
    ``baselines_tpu_torch.<pkg>`` (under the port's name where it differs), and the
    port's ``__all__`` lists exactly those."""
    ref = {"core": jax_core, "nn": jax_nn, "envs": jax_envs, "data": jax_data,
           "ops": jax_ops}[pkg]
    port = {"core": core, "nn": tnn, "envs": envs, "data": data, "ops": ops}[pkg]
    names = getattr(ref, "__all__", None) or [
        n for n in vars(ref) if not n.startswith("_") and callable(getattr(ref, n))]
    want = [PORT_NAME.get(n, n) for n in names]
    assert want, pkg
    for name in want:
        assert hasattr(port, name), f"baselines_tpu_torch.{pkg} lacks {name}"
    if hasattr(ref, "__all__"):
        assert port.__all__ == want
    assert core.Registry is Registry and core.math_util.__name__.endswith("core.math")
    assert ops.take_rows.__module__ == "baselines_tpu_torch.ops.gather"


def _towers_independent(module):
    pv = dict(module.network.named_parameters())
    vv = dict(module.value_network.named_parameters())
    assert pv.keys() == vv.keys() and pv
    for name in pv:
        assert pv[name] is not vv[name]
        assert pv[name].data_ptr() != vv[name].data_ptr()
        zero = float(pv[name].detach().abs().sum()) == 0.0  # the biases start at 0
        assert zero or not torch.equal(pv[name], vv[name]), name
    before = {k: v.detach().clone() for k, v in pv.items()}
    with torch.no_grad():
        for v in vv.values():
            v.add_(1.0)
    assert all(torch.equal(before[k], pv[k]) for k in pv)


@pytest.mark.parametrize("network", ["registry_test_copy", "class", "mlp"])
def test_value_network_copy_builds_two_towers(network):
    """``value_network="copy"`` from a registered name, a class or a zoo name gives a
    value tower with weights of its own, initialised after the policy's."""
    if network == "registry_test_copy":
        networks.register(network)(TinyNet)
    net = TinyNet if network == "class" else network
    pol = build_policy(Box(-1.0, 1.0, (3,)), Discrete(2), net, device="cpu",
                       generator=torch.Generator().manual_seed(1), value_network="copy")
    _towers_independent(pol.module)
    pdflat, vf, _ = pol.module(torch.ones((5, 3)))
    assert pdflat.shape == (5, 2) and vf.shape == (5,)


def test_value_network_copy_refuses_a_module():
    """One torch module cannot be two towers: "copy" with a module raises ValueError
    (the deliberate difference: the JAX package applies one flax module to two sets of
    params); shared or no value tower takes the module as it is."""
    module = TinyNet((3,))
    with pytest.raises(ValueError, match="value_network='copy' needs a network name"):
        build_policy(Box(-1.0, 1.0, (3,)), Discrete(2), module, device="cpu",
                     value_network="copy")
    pol = build_policy(Box(-1.0, 1.0, (3,)), Discrete(2), module, device="cpu")
    assert pol.module.network is module and pol.module.value_network is None
