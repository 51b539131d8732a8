"""The port's networks against the JAX package's on the CPU, with weights carried across
by baselines_tpu_torch/convert.py and loaded with ``strict=True``.

- Every network name of the JAX package builds in the port, and its whole policy tree
  (``pi`` and ``vf`` on the latent) loads name for name at the published input shapes.
- ``cnn_small``, ``impala_cnn`` and ``conv_only`` in f32 to 1e-5 relative (convolution
  sums in another order) and in bf16 to 2e-2 (activations rounded to bf16 between
  layers, tests/test_torch_nn.py's tolerance); ``impala_cnn`` at 22x22, where its
  max-pools pad (0, 1), (1, 1) and (0, 1), and ``conv_only`` at ImageIdentity36-v0's
  36x36x1.
- The recurrent networks over 8 steps with masks that reset some envs midway, the
  latent and the carry compared at every step to 1e-5 in f32, and ``unroll`` over the
  same sequence against those steps; with a bf16 encoder, its output to 2e-2 and the
  f32 cell on the same input to 1e-5.
- flax's default init drawn by the port's ``_lecun`` and the LSTM's orthogonal init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import init_params, rel_err

from baselines_tpu.algos.dqn.dqn import QNet as JaxQNet
from baselines_tpu.envs.spaces import Box as JaxBox, Discrete as JaxDiscrete
from baselines_tpu.nn.networks import get_network as jax_get_network
from baselines_tpu.nn.networks import network_names as jax_network_names
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.dqn.dqn import QNet
from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.nn.networks import _same_pool_pads, get_network, network_names
from baselines_tpu_torch.nn.policy import build_policy

# each name at the input it is published for: frames of 84x84x4, 21x21x64 packed for
# cnn_s2d, a flat vector for mlp and the lstms without an encoder
PUBLISHED_SHAPES = {"mlp": (4,), "lstm": (4,), "lnlstm": (4,), "cnn_s2d": (21, 21, 64)}


def test_every_jax_network_name_is_ported():
    assert network_names() == sorted(jax_network_names())


def _zeros_like_shapes(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)


@pytest.mark.parametrize("name", sorted(jax_network_names()))
def test_policy_tree_loads_strictly(name):
    """The JAX model's param tree at the published input shape (its shapes only, from
    ``jax.eval_shape``) loads into the port's model with ``strict=True``: every flax
    module has its port module of the same path and shape, and the latent width agrees,
    3872 into ``impala_cnn``'s ``Dense_0`` among them. The model is the policy, or for
    ``conv_only``, whose latent is 4-D, deepq's dueling QNet, which flattens it."""
    shape = PUBLISHED_SHAPES.get(name, (84, 84, 4))
    image = len(shape) == 3
    obs = jnp.zeros((2,) + shape, jnp.uint8 if image else jnp.float32)
    space = Box(0, 255, shape, np.uint8) if image else Box(-1, 1, shape)
    if name == "conv_only":
        shapes = jax.eval_shape(JaxQNet(jax_get_network(name), 6).init, jax.random.PRNGKey(0),
                                obs)
        module = QNet(get_network(name, ob_shape=shape), 6)
    else:
        jspace = JaxBox(0, 255, shape, np.uint8) if image else JaxBox(-1, 1, shape)
        jpol = jax_build_policy(jspace, JaxDiscrete(6), name)
        shapes = jax.eval_shape(jpol.init, jax.random.PRNGKey(0), obs)
        tpol = build_policy(space, Discrete(6), name, device="cpu")
        assert tpol.is_recurrent == ("lstm" in name)
        module = tpol.module
    module.load_state_dict(convert.policy_state_dict(_zeros_like_shapes(shapes)), strict=True)
    if name == "impala_cnn":
        assert module.network.Dense_0.in_features == 3872
    if name == "conv_only":
        assert module.network.latent_size == 7 * 7 * 64


def test_impala_pool_pads_as_xla():
    """XLA's SAME padding of a 3-wide, stride-2 window: the smaller half low."""
    assert [_same_pool_pads(n) for n in (84, 42, 21, 22, 11, 6)] == [
        (0, 1), (0, 1), (1, 1), (0, 1), (1, 1), (0, 1)]


FEEDFORWARD = {"cnn_small": (24, 24, 1), "impala_cnn": (22, 22, 4), "conv_only": (36, 36, 1)}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", sorted(FEEDFORWARD))
def test_feedforward_network_through_convert(name, dtype, tol):
    shape = FEEDFORWARD[name]
    x = np.random.RandomState(0).randint(0, 256, (6,) + shape).astype(np.uint8)
    jnet = jax_get_network(name, dtype=getattr(jnp, dtype))
    params = init_params(jnet.init, 1, jnp.asarray(x))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    net = get_network(name, ob_shape=shape, dtype=dtype)
    net.load_state_dict(convert.network_state_dict(params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert net.latent_size == int(np.prod(want.shape[1:]))
    assert rel_err(got, want) < tol
    assert (want > 0).mean() > 0.1


NSTEPS, NB, NLSTM = 8, 5, 16


def _sequence(shape, seed):
    rng = np.random.RandomState(seed)
    if len(shape) == 3:
        xs = rng.randint(0, 256, (NSTEPS, NB) + shape).astype(np.uint8)
    else:
        xs = rng.randn(NSTEPS, NB, *shape).astype(np.float32)
    masks = (rng.rand(NSTEPS, NB) < 0.3).astype(np.float32)
    masks[0] = 1.0
    masks[3, :2] = 1.0  # two envs reset midway, the others carry on
    masks[3, 2:] = 0.0
    return xs, masks


def _recurrent_pair(name, shape, dtype):
    """The JAX network and its moved init params, and the port's network loaded with
    them, with ``NLSTM`` cells and the encoder in ``dtype``."""
    xs, masks = _sequence(shape, 2)
    kwargs = {"nlstm": NLSTM}
    if dtype is not None:
        kwargs["dtype"] = getattr(jnp, dtype)
    jnet = jax_get_network(name, **kwargs)
    carry0 = (0.5 * np.random.RandomState(3).randn(NB, 2 * NLSTM)).astype(np.float32)
    params = init_params(jnet.init, 4, jnp.asarray(xs[0]), jnp.asarray(carry0),
                         jnp.asarray(masks[0]))
    if dtype is not None:
        kwargs["dtype"] = getattr(torch, dtype)
    net = get_network(name, ob_shape=shape, **kwargs)
    net.load_state_dict(convert.network_state_dict(params), strict=True)
    return jnet, params, net, xs, masks, carry0


RECURRENT = [("lstm", (6,)), ("lnlstm", (6,)), ("cnn_lstm", (36, 36, 1)),
             ("cnn_lnlstm", (36, 36, 1)), ("impala_cnn_lstm", (22, 22, 4))]


@pytest.mark.parametrize("name,shape", RECURRENT, ids=[n for n, _ in RECURRENT])
def test_recurrent_network_matches_jax_at_every_step(name, shape):
    """In f32, 8 steps of 5 envs from a nonzero carry, masks resetting some envs midway:
    the latent and the carry after every step to 1e-5 relative; then ``unroll`` over the
    whole sequence (the encoder and ``wx`` once over all 40 frames, then the cell step
    by step) gives the steps' latents and final carry to 1e-5 / 1e-6."""
    jnet, params, net, xs, masks, carry0 = _recurrent_pair(name, shape, None)
    apply = jax.jit(jnet.apply)
    jcarry, tcarry = jnp.asarray(carry0), torch.from_numpy(carry0)
    latents = []
    for t in range(NSTEPS):
        jlatent, jcarry = apply(params, jnp.asarray(xs[t]), jcarry, jnp.asarray(masks[t]))
        with torch.no_grad():
            tlatent, tcarry = net(torch.from_numpy(xs[t]), tcarry, torch.from_numpy(masks[t]))
        assert tlatent.dtype == tcarry.dtype == torch.float32
        assert rel_err(tlatent, jlatent) < 1e-5, t
        assert rel_err(tcarry, jcarry) < 1e-5, t
        latents.append(tlatent)
    assert float(np.abs(np.asarray(jcarry)).max()) > 0.05
    with torch.no_grad():
        seq, carry = net.unroll(torch.from_numpy(xs.reshape((NSTEPS * NB,) + shape)),
                                torch.from_numpy(carry0), torch.from_numpy(masks))
    torch.testing.assert_close(seq, torch.cat(latents), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(carry, tcarry, rtol=1e-5, atol=1e-6)


BF16_ENCODERS = [("cnn_lstm", (36, 36, 1)), ("cnn_lnlstm", (36, 36, 1)),
                 ("impala_cnn_lstm", (22, 22, 4))]


@pytest.mark.parametrize("name,shape", BF16_ENCODERS, ids=[n for n, _ in BF16_ENCODERS])
def test_recurrent_bf16_encoder_matches_jax_at_every_step(name, shape):
    """With the encoder in bf16 (the LSTM stays f32), at every step of the sequence: the
    encoder's output to 2e-2 relative, and the port's cell on JAX's encoder output and
    carry gives JAX's latent and next carry to 1e-5. The two are checked apart because
    the cell amplifies the encoder's bf16 rounding: end to end the latents differ by up
    to 2.5e-2 relative (measured on impala_cnn_lstm, whose encoder alone is at 1.1e-2),
    while every f32 network agrees to 1e-5 end to end (the test above)."""
    jnet, params, net, xs, masks, carry0 = _recurrent_pair(name, shape, "bfloat16")
    apply = jax.jit(jnet.apply)
    encode = jax.jit(lambda x: jnet.encoder.apply({"params": params["params"]["encoder"]}, x))
    jcarry = jnp.asarray(carry0)
    for t in range(NSTEPS):
        x, m = jnp.asarray(xs[t]), jnp.asarray(masks[t])
        jh = np.array(encode(x))
        jlatent, jnext = apply(params, x, jcarry, m)
        with torch.no_grad():
            h = net.encode(torch.from_numpy(xs[t]))
            latent, carry = net.lstm(torch.from_numpy(jh), torch.from_numpy(np.array(jcarry)),
                                     torch.from_numpy(masks[t]))
        assert h.dtype == torch.float32 and rel_err(h, jh) < 2e-2, t
        assert rel_err(latent, jlatent) < 1e-5, t
        assert rel_err(carry, jnext) < 1e-5, t
        jcarry = jnext


def test_default_init_draws_as_flax():
    """``impala_cnn``'s and ``conv_only``'s layers (flax's ``lecun_normal``): the spread
    of each weight sqrt(1 / fan_in) within five standard errors, as flax's own init of
    the same layer is, no weight beyond two of the untruncated normal's standard
    deviations, zero biases; the LSTM's ``wx`` and ``wh`` orthogonal with gain 1, as
    flax's."""
    jnet = jax_get_network("impala_cnn")
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 84, 84, 4), jnp.uint8))
    want = convert.network_state_dict(jax.tree_util.tree_map(np.asarray, params))
    net = get_network("impala_cnn", ob_shape=(84, 84, 4),
                      generator=torch.Generator().manual_seed(0))
    got = net.state_dict()
    assert set(got) == set(want)
    conv_only = get_network("conv_only", ob_shape=(84, 84, 4),
                            generator=torch.Generator().manual_seed(1))
    layers = [(name, w, want[name]) for name, w in got.items()]
    layers += [(f"conv_only.{name}", w, None) for name, w in conv_only.state_dict().items()]
    for name, w, flax_w in layers:
        if name.endswith("bias"):
            assert not w.any(), name
            continue
        fan_in = int(np.prod(w.shape[1:]))
        std = np.sqrt(1.0 / fan_in)  # the variance after the truncation is 1 / fan_in
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6), name
        # five standard errors of a sample standard deviation of w.numel() draws
        bound = 5 / np.sqrt(2 * w.numel())
        assert abs(float(w.std()) / std - 1) < bound, name
        if flax_w is not None:
            assert abs(float(flax_w.std()) / std - 1) < bound, name
    cell = get_network("lstm", ob_shape=(6,), nlstm=16).lstm
    for w in (cell.wx.weight, cell.wh.weight):
        s = torch.linalg.svdvals(w.detach())
        torch.testing.assert_close(s, torch.ones_like(s), rtol=1e-5, atol=1e-5)
    assert not cell.b.any()
