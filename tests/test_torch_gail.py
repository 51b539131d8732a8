"""The port's gail (algos/gail/) against the JAX package's, on the CPU: the adversary's
loss, reward and logit entropy; 20 behavior-cloning steps; one whole iteration of each
side from the same weights (carried across by convert.py), the same env state, the same
expert sample and the same draws (the expert indices, the rollout's, then the value
epochs' permutations, rebuilt from the JAX learner's key splits); the ``.npz`` loader;
and the checkpoint, which keeps more than the reference's does (see its test).

Tolerances: the adversary to 1e-5 relative; parameters to 1e-4 relative, after Adam
steps and a natural-gradient step whose f32 sums run in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ReplayDraws, base_env, init_params, move_params, push_epochs,
                          push_reset, push_rollout_step, rel_err)

from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.gail import adversary as jadv
from baselines_tpu.algos.gail import gail as jgail
from baselines_tpu.algos.gail.behavior_clone import pretrain_bc as jax_pretrain_bc
from baselines_tpu.algos.gail.dataset import ExpertDataset as JaxExpertDataset
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.core.running_stats import RunningMeanStd as JaxRunningMeanStd
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.gail import adversary, gail
from baselines_tpu_torch.algos.gail.behavior_clone import pretrain_bc
from baselines_tpu_torch.algos.gail.dataset import ExpertDataset, collect_expert
from baselines_tpu_torch.algos.trpo.trpo import split_params
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.nn.policy import build_policy


def _rms(rng, dim):
    mean = rng.randn(dim).astype(np.float32)
    var = (0.5 + rng.rand(dim)).astype(np.float32)
    return (JaxRunningMeanStd(jnp.asarray(mean), jnp.asarray(var), jnp.float32(37.0)),
            RunningMeanStd(torch.from_numpy(mean), torch.from_numpy(var), torch.tensor(37.0)))


def test_adversary_matches_jax():
    """The loss with its accuracies, the reward and the logit entropy of the same
    discriminator on the same rows, normalized by the same statistics, to 1e-5."""
    rng = np.random.RandomState(0)
    ob_dim, ac_dim, n = 3, 2, 64
    jdisc = jadv.Discriminator(hidden_size=16)
    dparams = init_params(jdisc.init, 0, jnp.zeros((1, ob_dim)), jnp.zeros((1, ac_dim)))
    tdisc = adversary.Discriminator(ob_dim, ac_dim, hidden_size=16)
    tdisc.load_state_dict(convert.network_state_dict(dparams))
    jrms, trms = _rms(rng, ob_dim)
    rows = [rng.randn(n, d).astype(np.float32) for d in (ob_dim, ac_dim, ob_dim, ac_dim)]
    jrows, trows = [jnp.asarray(r) for r in rows], [torch.from_numpy(r) for r in rows]

    want, jacc = jax.jit(lambda *a: jadv.adversary_loss(jdisc, *a, entcoeff=0.1))(
        dparams, jrms, *jrows)
    got, tacc = adversary.adversary_loss(tdisc, trms, *trows, entcoeff=0.1)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in ("gen_acc", "exp_acc"):
        assert float(tacc[k]) == float(jacc[k])
    assert 0 < float(tacc["gen_acc"]) < 1
    want_r = np.asarray(jax.jit(lambda *a: jadv.adversary_reward(jdisc, *a))(
        dparams, jrms, jrows[0], jrows[1]))
    got_r = adversary.adversary_reward(tdisc, trms, trows[0], trows[1]).detach().numpy()
    np.testing.assert_allclose(got_r, want_r, rtol=1e-5)
    logits = np.linspace(-30, 30, 61).astype(np.float32)
    np.testing.assert_allclose(
        adversary.logit_bernoulli_entropy(torch.from_numpy(logits)).numpy(),
        np.asarray(jadv._logit_bernoulli_entropy(jnp.asarray(logits))), rtol=1e-5, atol=1e-7)


def _identity_expert(n=5000):
    obs = np.random.RandomState(0).uniform(-1, 1, size=(n, 1)).astype(np.float32)
    return obs, obs.copy()


def _policy_params(jpol, ob_dim, seed=0):
    return init_params(jpol.init, seed, jnp.zeros((1, ob_dim)))


def test_behavior_cloning_matches_jax():
    """20 Adam steps of the filtered policy on expert minibatches of 32, the filter
    seeded from the expert rows, to 1e-4 of each parameter's change; the value tower,
    which the loss does not reach, does not move."""
    obs, acs = _identity_expert(500)
    jvenv = jax_build_env("BoxIdentity-v0", 1)
    jinner = jax_build_policy(jvenv.observation_space, jvenv.action_space, "mlp",
                              value_network="copy", num_hidden=16)
    jpol = jgail._ObsNormPolicy(jinner)
    inner_params = _policy_params(jinner, 1)
    jparams = {"pi": inner_params,
               "ob_rms": JaxRunningMeanStd.create((1,)).update(jnp.asarray(obs))}
    key = jax.random.PRNGKey(4)
    jds = JaxExpertDataset(obs=obs, acs=acs)
    want = jax_pretrain_bc(jpol, jparams, jds, key, max_iters=20, batch_size=32, lr=1e-3)

    draws, k = ReplayDraws(), key
    for _ in range(20):
        k, ks = jax.random.split(k)
        draws.push("randint", jax.random.randint(ks, (32,), 0, 500))
    tvenv = build_env("BoxIdentity-v0", 1, device="cpu")
    tpol = gail.ObsNormPolicy(build_policy(tvenv.observation_space, tvenv.action_space, "mlp",
                                           device="cpu", value_network="copy", num_hidden=16))
    start = convert.obs_norm_policy_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    tpol.module.load_state_dict(start)
    pretrain_bc(tpol, ExpertDataset(obs=obs, acs=acs, device="cpu"), draws, max_iters=20,
                batch_size=32, lr=1e-3)
    assert not draws.queue
    want_sd = convert.obs_norm_policy_state_dict(jax.tree_util.tree_map(np.asarray, want))
    moved = 0
    for name, p in tpol.module.state_dict().items():
        delta_want = want_sd[name].double() - start[name].double()
        delta_got = p.double() - start[name].double()
        if name.startswith(("pi.value_network.", "pi.vf.", "ob_rms")):
            assert float(delta_want.abs().max()) == float(delta_got.abs().max()) == 0, name
            continue
        moved += 1
        assert rel_err(delta_got, delta_want) < 1e-4, name
    assert moved == 7  # the latent's two layers, pi and logstd


NENVS, NSTEPS = 8, 64  # 512 samples: 8 value minibatches of 64 an epoch
HPARAMS = dict(max_kl=0.01, cg_iters=3, gamma=0.9, lam=0.97, ent_coef=0.0, cg_damping=0.1,
               vf_stepsize=1e-3, vf_iters=2, d_stepsize=3e-4, g_step=1, d_step=2,
               adversary_entcoeff=1e-3, fvp_subsample=5)


@pytest.fixture(scope="module")
def one_iteration():
    """One gail iteration of the JAX learner (learn for one batch, its initial policy and
    discriminator params replaced by moved flax inits through a wrapped ``dealias``, its
    metrics caught from ``logger.logkv``) and of the port's ``make_update_fn`` from the
    same state, expert sample and draws. The policy has a 32-unit mlp and the
    discriminator 32 units; conjugate gradient runs 3 trips, before the two sides' f32
    iterates part on BoxIdentity's few curvature directions (tests/test_torch_trpo.py)."""
    obs, acs = _identity_expert()
    jvenv = jax_build_env("BoxIdentity-v0", NENVS)
    captured, logged = [], {}

    def start_from_moved(state):
        if not captured:
            state = state.replace(
                params={"pi": move_params(state.params["pi"], 1), "ob_rms": state.params["ob_rms"]},
                d_params=move_params(state.d_params, 2))
            captured.append(jax.device_get(state))
        return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgail, "dealias", start_from_moved)
        mp.setattr(jax_logger, "logkv", lambda k, v: logged.__setitem__(k, v))
        mp.setattr(jax_logger, "dumpkvs", lambda: None)
        jmodel = jgail.learn(env_id="BoxIdentity-v0", network="mlp", num_hidden=32,
                             expert_dataset=JaxExpertDataset(obs=obs, acs=acs), seed=0,
                             num_envs=NENVS, timesteps_per_batch=NENVS * NSTEPS,
                             total_timesteps=NENVS * NSTEPS, adversary_hidden_size=32,
                             log_interval=1, **HPARAMS)
    jstart = captured[0]

    base = base_env(jvenv)
    draws = ReplayDraws()
    _, kreset, _, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    push_reset(draws, base, kreset, NENVS)
    key2 = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    draws.push("randint", jax.random.randint(key2, (NENVS * NSTEPS,), 0, len(obs)))
    k = jstart.key
    for _ in range(NSTEPS):
        k = push_rollout_step(draws, base, k, NENVS, jvenv.action_space)
    push_epochs(draws, k, HPARAMS["vf_iters"], NENVS * NSTEPS)

    tvenv = build_env("BoxIdentity-v0", NENVS, device="cpu", normalize=False)
    tpol = gail.ObsNormPolicy(build_policy(tvenv.observation_space, tvenv.action_space, "mlp",
                                           device="cpu", value_network="copy", num_hidden=32))
    start = convert.obs_norm_policy_state_dict(jstart.params)
    tpol.module.load_state_dict(start)
    disc = adversary.Discriminator(1, 1, hidden_size=32)
    dstart = convert.network_state_dict(jstart.d_params)
    disc.load_state_dict(dstart)
    vf_opt = ClipAdam(split_params(tpol.inner.module)[1].values(), None, eps=1e-8)
    d_opt = ClipAdam(disc.parameters(), None, eps=1e-8)
    tobs, env_state = tvenv.reset(draws)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jstart.obs), rtol=1e-6)
    state = gail.GAILTrainState(env_state=env_state, obs=tobs,
                                last_done=torch.zeros((NENVS,), dtype=torch.bool),
                                d_obs_rms=RunningMeanStd.create((1,), device="cpu"))
    update_fn = gail.make_update_fn(tpol, tvenv, disc, vf_opt, d_opt, nsteps=NSTEPS, **HPARAMS)
    exp_obs, exp_acs = ExpertDataset(obs=obs, acs=acs, device="cpu").sample(draws, NENVS * NSTEPS)
    tnew, tmetrics = update_fn(state, exp_obs, exp_acs, draws)
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jax.device_get(jmodel.state), jmetrics=logged, tnew=tnew,
                tmetrics=tmetrics, tpol=tpol, disc=disc, start=start, dstart=dstart)


def _assert_moved_like(got: dict, want: dict, start: dict, names, tol=1e-4):
    for name in names:
        base = start[name].double()
        delta_want = want[name].double() - base
        assert float(delta_want.abs().max()) > 0, name
        assert rel_err(got[name].double() - base, delta_want) < tol, name


def test_iteration_params_match_jax(one_iteration):
    """The policy's, the value tower's and the discriminator's params after the
    iteration: each tensor's change to 1e-4 of the JAX change, and the policy filter's
    and the discriminator's statistics to 1e-5."""
    run = one_iteration
    want = convert.obs_norm_policy_state_dict(run["jnew"].params)
    got = run["tpol"].module.state_dict()
    _assert_moved_like(got, want, run["start"], [n for n in got if not n.startswith("ob_rms")])
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(got[f"ob_rms_{f}"].numpy(), want[f"ob_rms_{f}"].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(getattr(run["tnew"].d_obs_rms, f).numpy(),
                                   np.asarray(getattr(run["jnew"].d_obs_rms, f)), rtol=1e-5)
    dwant = convert.network_state_dict(run["jnew"].d_params)
    _assert_moved_like(run["disc"].state_dict(), dwant, run["dstart"], list(dwant))


def test_iteration_metrics_match_jax(one_iteration):
    """Every metric the port logs to 1e-4 relative (1e-6 absolute for the gain, about 0
    at the old params); the accuracies exactly; the line search passed on both sides."""
    jm, tm = one_iteration["jmetrics"], one_iteration["tmetrics"]
    assert set(tm) <= set(jm)
    for k in tm:
        got, want = float(tm[k]), float(jm[k])
        if k.startswith("d_"):
            assert got == want, k
        else:
            assert abs(got - want) <= 1e-6 + 1e-4 * abs(want), (k, got, want)
    assert float(tm["linesearch_success"]) == 1.0
    assert one_iteration["tnew"].iters == int(one_iteration["jnew"].iters) == 1


def test_expert_npz_loader_matches_jax(tmp_path):
    """An .npz in the reference schema, obs (E, T, do) and acs (E, T, da), with
    traj_limitation: the same rows as the JAX loader, and a sample of them through the
    row gather with the JAX sample's indices."""
    rng = np.random.RandomState(1)
    obs = rng.randn(5, 7, 3).astype(np.float64)
    acs = rng.randn(5, 7, 2).astype(np.float32)
    path = str(tmp_path / "expert.npz")
    np.savez(path, obs=obs, acs=acs)
    for limit in (-1, 2):
        want = JaxExpertDataset(expert_path=path, traj_limitation=limit)
        got = ExpertDataset(expert_path=path, traj_limitation=limit, device="cpu")
        assert got.n == want.n == 7 * (5 if limit < 0 else limit)
        assert got.obs.dtype == torch.float32
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))
        np.testing.assert_array_equal(got.acs.numpy(), np.asarray(want.acs))
    key = jax.random.PRNGKey(3)
    wobs, wacs = want.sample(key, 9)
    draws = ReplayDraws()
    draws.push("randint", jax.random.randint(key, (9,), 0, want.n))
    gobs, gacs = got.sample(draws, 9)
    np.testing.assert_array_equal(gobs.numpy(), np.asarray(wobs))
    np.testing.assert_array_equal(gacs.numpy(), np.asarray(wacs))


def test_checkpoint_keeps_adversary_iters_and_vecnormalize(tmp_path):
    """The save/load round trip bit for bit: the filtered policy, the adversary (its
    params, Adam state and statistics), the value tower's Adam state, and two things
    the reference's save drops (ADVICE.md on gail.py:136 and :138), which the port keeps
    on purpose: the iteration count, so a continued run keeps the discriminator's
    cadence, and the VecNormalize statistics of a normalized env. A payload of the
    unfiltered policy's params alone loads into the unfiltered policy."""
    obs, acs = _identity_expert(300)
    kwargs = dict(env_id="BoxIdentity-v0",
                  expert_dataset=ExpertDataset(obs=obs, acs=acs, device="cpu"), seed=0,
                  num_envs=4, timesteps_per_batch=64, g_step=2, d_step=1,
                  num_hidden=8, adversary_hidden_size=8, vf_iters=1, cg_iters=2,
                  env_kwargs={"normalize": True}, log_interval=0, device="cpu")
    logger.configure(format_strs=[])
    try:
        model = gail.learn(total_timesteps=3 * 64, **kwargs)
        path = str(tmp_path / "gail.pt")
        model.save(path)
        loaded = gail.learn(total_timesteps=0, load_path=path, **kwargs)
    finally:
        logger.reset()
    assert model.state.iters == loaded.state.iters == 3
    for a, b in ((model.policy.module, loaded.policy.module), (model.disc, loaded.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert float(model.policy.module.ob_rms_count) > 1
    for opt_a, opt_b in ((model.d_opt, loaded.d_opt), (model.opt, loaded.opt)):
        assert opt_a.count == opt_b.count > 0
        assert all(torch.equal(x, y) for x, y in zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu))
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(model.state.d_obs_rms, f), getattr(loaded.state.d_obs_rms, f))
    ns, ls = model._normalize_state(), loaded._normalize_state()
    for a, b in ((ns.ob_rms, ls.ob_rms), (ns.ret_rms, ls.ret_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    assert float(ns.ob_rms.count) > 100

    legacy = str(tmp_path / "legacy.pt")
    torch.save({"model_params": model.policy.inner.module.state_dict()}, legacy)
    old = gail.learn(total_timesteps=0, load_path=legacy, **dict(kwargs, num_hidden=6))
    assert old.policy.module.network.mlp_fc0.weight.shape == (8, 1)  # the file's width
    assert not isinstance(old.policy, gail.ObsNormPolicy)
    want = model.policy.inner.module.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in old.policy.module.state_dict().items())


def test_collect_expert_and_pretraining_in_learn():
    """``collect_expert`` rolls the model's deterministic policy from a reset and keeps
    every (observation, action) pair, time-major flattened (the actions to rounding of
    the policy's mode on the kept rows); ``learn(pretrained=True)``
    seeds the policy's filter from the expert rows and clones them before training."""
    venv = build_env("BoxIdentity-v0", 4, device="cpu")
    obs, acs = _identity_expert(200)
    kwargs = dict(env=venv, expert_dataset=ExpertDataset(obs=obs, acs=acs, device="cpu"), seed=3,
                  total_timesteps=0, num_hidden=8, device="cpu")
    plain = gail.learn(**kwargs)
    cloned = gail.learn(pretrained=True, bc_max_iters=3, **kwargs)
    assert float(cloned.policy.module.ob_rms_count) == pytest.approx(200 + 1e-4)
    assert float(plain.policy.module.ob_rms_count) == pytest.approx(1e-4)
    moved = [n for n, p in cloned.policy.module.named_parameters()
             if not torch.equal(p, plain.policy.module.get_parameter(n))]
    assert moved and all(not n.startswith(("pi.value_network", "pi.vf")) for n in moved)

    ds = collect_expert(cloned, venv, Draws(0, "cpu"), nsteps=5)
    assert ds.n == 20 and ds.obs.shape == (20, 1) and ds.acs.shape == (20, 1)
    with torch.no_grad():  # a batch of 20 sums in another order than one of 4
        want = cloned.policy.mode_step(ds.obs)[0]
    torch.testing.assert_close(ds.acs, want, rtol=1e-6, atol=1e-7)
