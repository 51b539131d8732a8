"""The port's acktr (algos/acktr/) against the JAX package's, on the CPU: K-FAC's factor
statistics and its preconditioned gradient on random SPD factors; the conv net's KFC rows
and its identity-factor preconditioning (the ports of tests/test_acktr_learning.py's two
conv tests); and two whole updates of each side from the same weights (carried across by
convert.py, the first dense layer's rows permuted from (H, W, C) to (C, H, W)), the same
env state and the same draws (the rollout's, then the Fisher loss's noise), the first a
cold-start step, the second a K-FAC step with its KL clip.

Eigenvectors are not unique (a sign, or a rotation inside a repeated eigenvalue), so no
test compares them: the preconditioned gradient is the quantity that must agree.
Tolerances: statistics and rows to 1e-5 relative, preconditioned gradients, params and
momentum to 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ReplayDraws, base_env, move_params, push_reset, push_rollout_step,
                          rel_err)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.acktr import acktr as jacktr
from baselines_tpu.algos.acktr import kfac as jkfac
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.acktr import acktr, kfac
from baselines_tpu_torch.algos.common import build_env
from baselines_tpu_torch.envs.registry import make_env


def _spd(rng, n):
    """An SPD matrix with distinct eigenvalues spread over two decades."""
    q, _ = np.linalg.qr(rng.randn(n, n))
    lam = np.linspace(0.05, 5.0, n) * (1 + 0.01 * rng.rand(n))
    return (q @ np.diag(lam) @ q.T).astype(np.float32)


def test_stats_eigs_and_preconditioned_gradient_match_jax():
    """update_stats on rows of two layers to 1e-5; then update_eigs and
    precondition_layer on SPD factors with distinct eigenvalues: the preconditioned
    gradient to 1e-4; the spectrum clamped at 0 on both sides."""
    rng = np.random.RandomState(0)
    dims = [(5, 4), (4, 3)]
    jstate = jkfac.init_kfac(dims, {"w": jnp.zeros(2)})
    tstate = kfac.init_kfac(dims, [torch.zeros(2)], "cpu")
    rows = [(rng.randn(40, din).astype(np.float32), rng.randn(40, dout).astype(np.float32))
            for din, dout in dims]
    jstate = jax.jit(jkfac.update_stats, static_argnums=2)(
        jstate, [tuple(map(jnp.asarray, r)) for r in rows], 0.9)
    tstate = kfac.update_stats(tstate, [tuple(map(torch.from_numpy, r)) for r in rows], 0.9)
    for jl, tl in zip(jstate.layers, tstate.layers):
        np.testing.assert_allclose(tl.A.numpy(), np.asarray(jl.A), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tl.S.numpy(), np.asarray(jl.S), rtol=1e-5, atol=1e-7)

    layers = []
    for din, dout in ((6, 5), (9, 3)):
        A, S = _spd(rng, din + 1), _spd(rng, dout)
        A[0, 0] -= 0.2  # one eigenvalue of A below 0 after the shift: clamped
        A -= np.eye(din + 1, dtype=np.float32) * 0.1
        layers.append((A, S))
    jstate = jstate.replace(layers=tuple(
        jkfac.init_layer(a.shape[0] - 1, s.shape[0]).replace(A=jnp.asarray(a), S=jnp.asarray(s))
        for a, s in layers))
    tstate = kfac.KFACState(layers=[
        kfac.LayerKFACState(A=torch.from_numpy(a), S=torch.from_numpy(s), QA=None, lamA=None,
                            QS=None, lamS=None) for a, s in layers], momentum=[])
    tstate = kfac.update_eigs(tstate)
    jstate = jax.jit(jkfac.update_eigs)(jstate)
    precondition = jax.jit(jkfac.precondition_layer, static_argnums=3)
    for (a, s), jl, tl in zip(layers, jstate.layers, tstate.layers):
        assert float(tl.lamA.min()) >= 0 and float(jnp.min(jl.lamA)) >= 0
        np.testing.assert_allclose(tl.lamS.numpy(), np.asarray(jl.lamS), rtol=1e-5)
        gW = rng.randn(a.shape[0] - 1, s.shape[0]).astype(np.float32)
        gb = rng.randn(s.shape[0]).astype(np.float32)
        want = precondition(jl, jnp.asarray(gW), jnp.asarray(gb), 0.01)
        got = kfac.precondition_layer(tl, torch.from_numpy(gW), torch.from_numpy(gb), 0.01)
        for g, w in zip(got, want):
            assert rel_err(g.numpy(), np.asarray(w)) < 1e-4


def _nets(env_id: str, seed: int = 0):
    """The JAX and the port's cnn_small KfacPolicyNet with the same (moved) params."""
    jenv, tenv = jax_make_env(env_id), make_env(env_id)
    jnet = jacktr.KfacPolicyNet(jenv.observation_space, jenv.action_space, "cnn_small")
    params = move_params(jnet.init(jax.random.PRNGKey(seed)), seed)
    tnet = acktr.KfacPolicyNet(tenv.observation_space, tenv.action_space, "cnn_small")
    tnet.load_state_dict(convert.kfac_state_dict(params, tnet.conv_out_hw))
    return jnet, params, tnet


def test_kfac_conv_precondition_identity_factors():
    """With identity factors F^-1 g is g / (1 + eps) for every layer, conv kernels
    included: their round trip through the (cin * k * k, cout) factor layout is exact
    (tests/test_acktr_learning.py:87-107)."""
    env = make_env("ImageIdentity-v0")
    net = acktr.KfacPolicyNet(env.observation_space, env.action_space, "cnn_small")
    state = kfac.init_kfac(net.layer_dims, net.parameters(), "cpu")
    grads = [(torch.ones_like(m.weight), torch.ones_like(m.bias)) for m in net.kfac_modules]
    eps = 0.25
    for (pW, pb), (gW, gb) in zip(net.precondition(state.layers, grads, eps), grads):
        assert pW.shape == gW.shape and pb.shape == gb.shape
        torch.testing.assert_close(pW, gW / (1 + eps), rtol=0, atol=1e-5)
        torch.testing.assert_close(pb, gb / (1 + eps), rtol=0, atol=1e-5)


def test_kfac_conv_patch_stats_match_jax():
    """layer_stats of one Fisher backward on the same params, observations, actions and
    noise: (batch * locations, cin * k^2) patch rows and (batch * locations, cout)
    gradient rows for the convs (tests/test_acktr_learning.py:110-131), every layer's
    rows to 1e-5 of JAX's, the first dense layer's input columns in (C, H, W) order: on
    ImageIdentity36-v0, whose convs end at 3 x 3 x 16, so that the order matters."""
    jnet, params, tnet = _nets("ImageIdentity36-v0", 1)
    rng = np.random.RandomState(2)
    n = 6
    obs = rng.rand(n, *tnet.ob_space.shape).astype(np.float32)
    ac = rng.randint(0, 4, n).astype(np.int32)
    noise = rng.randn(n).astype(np.float32)

    def jfisher(taps):
        pdflat, vf, _ = jnet.forward(params, jnp.asarray(obs), taps)
        pd = jnet.pdtype.pdfromflat(pdflat)
        return -jnp.mean(pd.neglogp(jnp.asarray(ac))) - jnp.mean(
            jnp.square(vf - jax.lax.stop_gradient(vf + jnp.asarray(noise))))

    @jax.jit
    def jstats(taps):
        _, _, jacts = jnet.forward(params, jnp.asarray(obs))
        return jnet.layer_stats(jacts, jax.grad(jfisher)(taps))

    jrows = jstats(jnet.zero_taps(n))
    taps = tnet.zero_taps(n, "cpu")
    pdflat, vf, acts = tnet(torch.from_numpy(obs), taps)
    neglogp = tnet.pdtype.pdfromflat(pdflat).neglogp(torch.from_numpy(ac))
    fisher = -torch.mean(neglogp) - torch.mean(
        torch.square(vf - (vf + torch.from_numpy(noise)).detach()))
    trows = tnet.layer_stats([a.detach() for a in acts], torch.autograd.grad(fisher, taps))
    assert len(trows) == len(jrows) == len(tnet.specs) == 5
    hw = tnet.conv_out_hw
    for i, (spec, (ta, tg), (ja, jg)) in enumerate(zip(tnet.specs, trows, jrows)):
        fdin, fdout = spec.factor_dims
        assert ta.shape[1] == fdin and tg.shape[1] == fdout and ta.shape[0] == tg.shape[0]
        if spec.kind == "conv":
            assert ta.shape[0] == n * spec.hout * spec.wout
        ja = np.asarray(ja)
        if i == 2:  # the first dense layer reads the conv output flattened
            ja = ja.reshape(n, hw[0], hw[1], -1).transpose(0, 3, 1, 2).reshape(n, -1)
        np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-5, atol=1e-6)
        assert rel_err(tg.numpy(), np.asarray(jg)) < 1e-5, i


NSTEPS = 8
CASES = {"mlp": ("DiscreteIdentity-v0", "mlp"), "cnn_small": ("ImageIdentity-v0", "cnn_small")}
HPARAMS = dict(cold_iter=1, kfac_update=1, gamma=0.9, lr=0.25, kfac_clip=0.001)


@pytest.fixture(scope="module", params=list(CASES))
def two_updates(request):
    """Two acktr updates of the JAX learner (learn for two batches, its params replaced
    by moved ones through a wrapped ``jit_init``) and of the port's ``make_update_fn``
    from the same state and draws, 8 envs x 8 steps."""
    env_id, network = CASES[request.param]
    nenvs = 8
    jvenv = jax_build_env(env_id, nenvs)
    starts = []

    def start_from_moved(make_state, key):
        state = make_state(key)
        state = state.replace(params=move_params(state.params, 3))
        starts.append(jax.device_get(state))
        return jax_common.dealias(state)  # as the jitted init leaves it

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_from_moved)
        mp.setattr(jax_logger, "logkv", lambda k, v: None)
        mp.setattr(jax_logger, "dumpkvs", lambda: None)
        jmodel = jacktr.learn(env_id=env_id, network=network, seed=0, num_envs=nenvs,
                              nsteps=NSTEPS, total_timesteps=2 * nenvs * NSTEPS,
                              log_interval=1, **HPARAMS)
    jstart, = starts

    base = base_env(jvenv)
    draws = ReplayDraws()
    _, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, nenvs)
    k = jstart.key
    for _ in range(2):
        for _ in range(NSTEPS):
            k = push_rollout_step(draws, base, k, nenvs, jvenv.action_space)
        k, knoise = jax.random.split(k)
        draws.push("normal", jax.random.normal(knoise, (nenvs * NSTEPS,)))

    tvenv = build_env(env_id, nenvs, device="cpu")
    net = acktr.KfacPolicyNet(tvenv.observation_space, tvenv.action_space, network)
    start = convert.kfac_state_dict(jstart.params, net.conv_out_hw)
    net.load_state_dict(start)
    policy = acktr.KfacPolicy(net, tvenv.observation_space, tvenv.action_space)
    obs, env_state = tvenv.reset(draws)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jstart.obs))
    state = acktr.ACKTRTrainState(env_state=env_state, obs=obs,
                                  last_done=torch.zeros((nenvs,), dtype=torch.bool),
                                  kfac=kfac.init_kfac(net.layer_dims, net.parameters(), "cpu"))
    update_fn = acktr.make_update_fn(
        policy, tvenv, nsteps=NSTEPS, ent_coef=0.01, vf_coef=0.5, vf_fisher_coef=1.0,
        max_grad_norm=0.5, lrschedule="linear", epsilon=0.01, stats_decay=0.99, momentum=0.9,
        nupdates=2, **HPARAMS)
    for _ in range(2):
        state, metrics = update_fn(state, draws)
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jax.device_get(jmodel.state), tnew=state, net=net, start=start,
                conv_hw=net.conv_out_hw)


def test_two_updates_params_and_momentum_match_jax(two_updates):
    """After a cold-start step and a K-FAC step: each param's change and each momentum
    tensor to 1e-4 relative of JAX's; the K-FAC step ran (step 2) and its factors moved
    from the identity."""
    run = two_updates
    want = convert.kfac_state_dict(run["jnew"].params, run["conv_hw"])
    got = run["net"].state_dict()
    for name, p in got.items():
        base = run["start"][name].double()
        delta_want = want[name].double() - base
        assert float(delta_want.abs().max()) > 0, name
        assert rel_err(p.double() - base, delta_want) < 1e-4, name
    jmom = convert.kfac_state_dict(run["jnew"].kfac.momentum, run["conv_hw"])
    names = [n for n, _ in run["net"].named_parameters()]
    tnew = run["tnew"]
    assert tnew.kfac.step == int(run["jnew"].kfac.step) == 2 and tnew.update_idx == 2
    for name, m in zip(names, tnew.kfac.momentum):
        assert rel_err(m.double(), jmom[name].double()) < 1e-4, name
    for layer in tnew.kfac.layers:
        assert not torch.equal(layer.A, torch.eye(layer.A.shape[0]))
