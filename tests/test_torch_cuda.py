"""The port's CUDA kernels against their plain versions, on the card, at shapes that
reach every path of each kernel (batch tails, every split of the dense stage's depth,
every copy width of the gather). Without a card these tests skip. On a machine with the card, where JAX is
not installed, run them without the suite's conftest.py, which sets JAX up:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or of baselines_tpu."""

import pytest
import torch

from baselines_tpu_torch.nn.networks import NatureCNNS2D
from baselines_tpu_torch.ops.fused_cnn import fused_cnn_forward, pack_params, reference_forward
from baselines_tpu_torch.ops.gather import take_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("batch", [1, 3, 63, 64, 65, 256, 600, 1029, 8192])
def test_fused_cnn_kernel_matches_plain(dev, batch):
    """Relative error < 2e-2 (bf16 activations, sums in another order) at batches that
    end in a partial 64-sample tile and that split the dense stage's depth 8 (up to 512
    samples), 4 (600), 2 (1029) ways or not at all (8192); the same bits from a second
    call (the split sums in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    x = torch.randint(0, 256, (batch, 21, 21, 64), dtype=torch.uint8, device=dev, generator=gen)
    net = NatureCNNS2D(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).to(dev)
    packed = pack_params(net)
    before = fused_cnn_forward.launches
    got = fused_cnn_forward(x, packed)
    want = reference_forward(x, packed)
    torch.cuda.synchronize()
    assert fused_cnn_forward.launches == before + 1
    assert got.shape == (batch, 512) and bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 2e-2, rel
    assert torch.equal(fused_cnn_forward(x, packed), got)
    with torch.no_grad():
        module = net(x)
    assert float((got - module).abs().max() / module.abs().max()) < 2e-2


@pytest.mark.parametrize("m", [1, 7, 256, 32768])
@pytest.mark.parametrize("shape,dtype", [
    ((300, 21, 21, 64), torch.uint8),  # wide rows of 16-byte units
    ((300, 21, 21, 63), torch.uint8),  # wide rows that are not a multiple of 16 bytes
    ((300,), torch.float32),  # 4-byte units
    ((300, 2), torch.float32),  # 8-byte units
    ((300, 3), torch.float32),  # 12-byte rows (Pendulum's obs) of 4-byte units
    ((300, 6), torch.float32),  # 24-byte rows (Acrobot's obs) of 8-byte units
    ((300,), torch.int64),  # 8-byte units
    ((300, 3), torch.int16),  # 2-byte units
    ((300, 7), torch.uint8),  # single bytes
    ((300,), torch.bool),  # single bytes
], ids=["u8_obs", "u8_ragged", "f32", "f32x2", "f32x3", "f32x6", "i64", "i16x3", "u8x7",
        "bool"])
def test_take_rows_kernel_matches_x_idx(dev, shape, dtype, m):
    """Bit for bit, with duplicate indices, from 1 row to the epoch shuffle's 32768."""
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randint(-100, 100, shape, device=dev, generator=gen).to(dtype)
    idx = torch.randint(0, shape[0], (m,), device=dev, generator=gen)
    got = take_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, x[idx])


def test_take_rows_kernel_on_unaligned_rows(dev):
    """A view that starts one byte in falls back to narrower units and stays exact."""
    base = torch.randint(0, 256, (65 * 64 + 1,), dtype=torch.uint8, device=dev)
    x = base[1:].view(65, 64)
    idx = torch.arange(64, -1, -1, device=dev)
    assert torch.equal(take_rows(x, idx), x[idx])


@pytest.mark.parametrize("shape", [(4, 5), (4, 21, 21, 64)])
def test_take_rows_kernel_zeroes_rows_of_out_of_range_indices(dev, shape):
    x = torch.ones(shape, device=dev)
    idx = torch.tensor([0, 4, -1, 3], device=dev)
    got = take_rows(x, idx)
    row = float(x[0].numel())
    assert torch.equal(got.reshape(4, -1).sum(dim=1).cpu(), torch.tensor([row, 0.0, 0.0, row]))


def _integer_priorities(gen, n, dev, block_total=4096):
    """Integer priorities with runs of zeros and equal block sums (see
    tests/test_torch_sampler.py): every sum is exact."""
    p = torch.randint(0, 4, (n // 2048, 2048), generator=gen, device=dev).float()
    p[:, 100:300] = 0.0
    p[:, -1] = 0.0
    p[:, -1] = block_total - p.sum(dim=1)
    return p.reshape(-1).contiguous()


@pytest.mark.parametrize("n,batch", [
    (2 ** 20, 32), (2 ** 20, 256), (10240, 256),  # the shapes of chip_smoke.py
    (51200, 32),  # 25 blocks: deepq's 50000-slot ring (Acrobot-v1, CartPole-v1), batch 32
    (2048, 64),  # one block
    (6144, 45),  # a batch that is not a multiple of 32, nor of the 8 targets of a block
])
def test_stratified_sample_kernel_matches_plain(dev, n, batch):
    """Bit for bit on integer priorities, with zero uniforms (targets on block and slot
    boundaries) and random ones, block sums included; within 2 slots, under 5 %
    differing, on |randn|. One launch a call."""
    from baselines_tpu_torch.ops import stratified_sample as ss

    gen = torch.Generator(device=dev).manual_seed(n + batch)
    ints = _integer_priorities(gen, n, dev)
    before = ss.stratified_sample.launches
    for u in (torch.zeros(batch, device=dev), torch.rand(batch, generator=gen, device=dev)):
        got, sums = ss.stratified_sample(ints, u, batch, return_block_sums=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (batch,)
        assert torch.equal(sums, ss.plain_block_sums(ints))
        assert torch.equal(got, ss.plain_stratified_sample(ints, u, batch))
    assert ss.stratified_sample.launches == before + 2
    prios = torch.randn(n, generator=gen, device=dev).abs()
    u = torch.rand(batch, generator=gen, device=dev)
    got = ss.stratified_sample(prios, u, batch).long()
    want = ss.plain_stratified_sample(prios, u, batch).long()
    assert int((got - want).abs().max()) <= 2
    assert float((got != want).float().mean()) < 0.05


@pytest.mark.parametrize("batch", [1, 31, 256, 257, 1024])
@pytest.mark.parametrize("nblocks", [1, 5, 8, 9, 16, 17, 512])
def test_stratified_sample_kernel_cluster_and_target_edges(dev, nblocks, batch):
    """Bit for bit on integer priorities (zero and random uniforms, block sums included)
    where the cluster's share of the blocks changes (fewer blocks than a cluster's 8, 8, 9,
    16, 17, and a million slots streamed from device memory) and where the targets fill
    part of a warp, one warp, more than one and several in turn; within 2 slots on
    |randn|."""
    from baselines_tpu_torch.ops import stratified_sample as ss

    n = nblocks * 2048
    gen = torch.Generator(device=dev).manual_seed(nblocks * 10007 + batch)
    ints = _integer_priorities(gen, n, dev)
    for u in (torch.zeros(batch, device=dev), torch.rand(batch, generator=gen, device=dev)):
        got, sums = ss.stratified_sample(ints, u, batch, return_block_sums=True)
        torch.cuda.synchronize()
        assert torch.equal(sums, ss.plain_block_sums(ints))
        assert torch.equal(got, ss.plain_stratified_sample(ints, u, batch))
    prios = torch.randn(n, generator=gen, device=dev).abs()
    u = torch.rand(batch, generator=gen, device=dev)
    got = ss.stratified_sample(prios, u, batch).long()
    want = ss.plain_stratified_sample(prios, u, batch).long()
    assert int((got - want).abs().max()) <= 2
    assert int((got != want).sum()) <= 0.05 * batch


def test_stratified_sample_kernel_names_its_shared_memory_limit(dev):
    from baselines_tpu_torch.ops import stratified_sample as ss

    prios = torch.zeros((ss.MAX_BLOCKS + 1) * 2048, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ss.stratified_sample(prios, torch.zeros(8, device=dev), 8)


def test_prioritized_buffer_samples_through_the_kernel(dev):
    """One whole PrioritizedReplayBuffer.sample on the card, with a capacity padded to
    10240 slots: the kernel's indices equal the plain version's on
    the same (integer) priorities, the batch is the rows at those indices and the
    weights are finite and at most 1."""
    from baselines_tpu_torch.data.prioritized import PrioritizedReplayBuffer
    from baselines_tpu_torch.ops import stratified_sample as ss

    class Uniforms:
        def __init__(self, u):
            self.u = u

        def uniform(self, shape, low, high):
            return self.u

    cap, batch = 10000, 256
    rb = PrioritizedReplayBuffer(cap, alpha=1.0)
    item = {"obs": torch.zeros((21, 21, 64), dtype=torch.uint8, device=dev),
            "reward": torch.zeros((), device=dev)}
    state = rb.init(item)
    assert state.priorities.shape == (10240,)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        b = 4000
        state = rb.add_batch(state, {
            "obs": torch.randint(0, 256, (b, 21, 21, 64), dtype=torch.uint8, device=dev,
                                 generator=gen),
            "reward": torch.randn(b, generator=gen, device=dev)})
    assert state.buffer.size == cap and state.buffer.ptr == 2000
    new = torch.randint(1, 5, (cap,), generator=gen, device=dev).float()
    state = rb.update_priorities(state, torch.arange(cap, device=dev), new)
    u = torch.rand(batch, generator=gen, device=dev)
    before = ss.stratified_sample.launches
    got, idx, weights = rb.sample(state, Uniforms(u), batch, beta=0.4)
    torch.cuda.synchronize()
    assert ss.stratified_sample.launches == before + 1
    want = ss.plain_stratified_sample(state.priorities, u, batch).long().clamp(max=cap - 1)
    assert torch.equal(idx, want)
    assert torch.equal(got["obs"], state.buffer.data["obs"][idx])
    assert torch.equal(got["reward"], state.buffer.data["reward"][idx])
    assert bool(torch.isfinite(weights).all()) and float(weights.max()) <= 1.0


def test_cartpole_step_on_the_card_matches_the_cpu(dev):
    """CartPole's step on the card against the same step on the CPU, rtol 1e-6 / atol
    1e-7: the card's sin/cos may round otherwise, and the divisions are true f32
    divisions on both (not products with a reciprocal)."""
    from baselines_tpu_torch.envs.classic.cartpole import CartPole, CartPoleState

    gen = torch.Generator().manual_seed(0)
    v = (torch.rand((4, 4096), generator=gen) - 0.5) * 0.4
    v[1] *= 10
    v[3] *= 10
    action = torch.randint(0, 2, (4096,), generator=gen, dtype=torch.int32)
    env = CartPole()
    cpu = env.step(None, CartPoleState(*v), action)
    card = env.step(None, CartPoleState(*v.to(dev)), action.to(dev))
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-6, atol=1e-7)
    assert torch.equal(card[3].cpu(), cpu[3]) and 0 < int(cpu[3].sum()) < 4096


def test_checkpoints_cross_between_the_card_and_the_cpu(dev, tmp_path):
    """A ppo2 model trained on the card loads into a CPU learner through ``load_path``,
    and a CPU model into a card learner; a run resumed on the card from its periodic
    checkpoint (the CUDA generator's state saved as CPU bytes) ends with the
    uninterrupted run's params bit for bit."""
    import shutil

    from baselines_tpu_torch.algos.ppo.ppo import learn
    from baselines_tpu_torch.core import logger

    kwargs = dict(env_id="CartPole-v1", num_envs=16, nsteps=32, nminibatches=2,
                  noptepochs=2, seed=0, log_interval=100)

    def run(logdir, device, **kw):
        logger.configure(dir=str(logdir), format_strs=[])
        try:
            return learn(device=device, **dict(kwargs, **kw))
        finally:
            logger.reset()

    on_card = run(tmp_path / "card", "cuda", total_timesteps=3 * 512, save_interval=1)
    on_card.save(str(tmp_path / "card.pt"))
    on_cpu = run(tmp_path / "cpu", "cpu", total_timesteps=0,
                 load_path=str(tmp_path / "card.pt"))
    for p, q in zip(on_card.policy.module.parameters(), on_cpu.policy.module.parameters()):
        assert q.device.type == "cpu" and torch.equal(p.cpu(), q)
    on_cpu.save(str(tmp_path / "cpu.pt"))
    back = run(tmp_path / "back", "cuda", total_timesteps=0, load_path=str(tmp_path / "cpu.pt"))
    for p, q in zip(on_card.policy.module.parameters(), back.policy.module.parameters()):
        assert q.device.type == "cuda" and torch.equal(p, q)

    resumed_dir = tmp_path / "resumed" / "checkpoints"
    resumed_dir.mkdir(parents=True)
    shutil.copy(tmp_path / "card" / "checkpoints" / "00002", resumed_dir / "00002")
    resumed = run(tmp_path / "resumed", "cuda", total_timesteps=3 * 512, save_interval=1)
    assert resumed.state.update_idx == on_card.state.update_idx == 3
    for p, q in zip(on_card.policy.module.parameters(), resumed.policy.module.parameters()):
        assert torch.equal(p, q)


class _SameDraws:
    """Draws made on the CPU from one seed and moved to ``device``, so the card and the
    CPU step from the same numbers."""

    def __init__(self, seed, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def uniform(self, shape, low, high):
        return (torch.rand(shape, generator=self.gen) * (high - low) + low).to(self.device)

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen).to(self.device)


@pytest.mark.parametrize("env_id", ["Pendulum-v1", "Acrobot-v1"])
def test_classic_step_on_the_card_matches_the_cpu(dev, env_id):
    """Pendulum's and Acrobot's steps on the card against the same steps on the CPU,
    from the same resets and actions, 20 steps of 4096 envs: obs and rewards to rtol
    1e-5 / atol 1e-5 (the card's sin/cos may round otherwise, and Acrobot's RK4 carries
    that on), dones equal where the CPU's height test is more than 1e-5 from its
    threshold."""
    from baselines_tpu_torch.envs.registry import make_env

    env, n = make_env(env_id), 4096
    cpu_obs, cpu_state = env.reset(_SameDraws(0, "cpu"), n, "cpu")
    card_obs, card_state = env.reset(_SameDraws(0, dev), n, dev)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        if env_id == "Pendulum-v1":
            action = torch.rand((n, 1), generator=gen) * 4 - 2
        else:
            action = torch.randint(0, 3, (n,), generator=gen, dtype=torch.int32)
        cpu = env.step(None, cpu_state, action)
        card = env.step(None, card_state, action.to(dev))
        cpu_state, card_state = cpu[1], card[1]
        torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(card[2].cpu(), cpu[2], rtol=1e-5, atol=1e-5)
        if env_id == "Acrobot-v1":
            s = cpu_state.inner.s.double()
            clear = (-torch.cos(s[:, 0]) - torch.cos(s[:, 1] + s[:, 0]) - 1).abs() > 1e-5
            assert torch.equal(card[3].cpu()[clear], cpu[3][clear])
            assert int(clear.sum()) > n - 8
        else:
            assert not card[3].any()


def test_vec_normalize_on_the_card_matches_the_cpu(dev):
    """VecNormalize over 8 Pendulum envs with VecRewardScale(0.1), 30 steps on the card
    and on the CPU from the same draws and actions: the normalized obs and rewards to
    rtol 1e-4 / atol 1e-5, ob_rms and ret_rms to rtol 1e-5 (the card's mean and variance
    sum in another order), their counts bit for bit."""
    from baselines_tpu_torch.algos.common import build_env
    from baselines_tpu_torch.envs.vec import find_normalize_state

    n = 8
    out = {}
    for device in ("cpu", dev):
        venv = build_env("Pendulum-v1", n, device=device, normalize=True, reward_scale=0.1)
        draws = _SameDraws(3, device)
        obs, state = venv.reset(draws)
        gen = torch.Generator().manual_seed(4)
        seen = []
        for _ in range(30):
            action = (torch.rand((n, 1), generator=gen) * 6 - 3).to(device)
            obs, state, rew, done, _ = venv.step(draws, state, action)
            seen.append(torch.cat([obs, rew[:, None]], dim=1).cpu())
        out[str(device)] = (torch.stack(seen), find_normalize_state(state))
    (cpu_seen, cpu_ns), (card_seen, card_ns) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(card_seen, cpu_seen, rtol=1e-4, atol=1e-5)
    for name in ("ob_rms", "ret_rms"):
        a, b = getattr(card_ns, name), getattr(cpu_ns, name)
        torch.testing.assert_close(a.mean.cpu(), b.mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a.var.cpu(), b.var, rtol=1e-5, atol=1e-6)
        assert torch.equal(a.count.cpu(), b.count)


@pytest.mark.parametrize("name,shape", [
    ("cnn_small", (84, 84, 4)), ("impala_cnn", (84, 84, 4)), ("conv_only", (84, 84, 4)),
    ("lnlstm", (6,)), ("cnn_lstm", (84, 84, 4)), ("impala_cnn_lstm", (84, 84, 4)),
])
def test_network_on_the_card_matches_the_cpu(dev, name, shape):
    """The fifth slice's networks in f32 (TF32 off) on the card against the CPU on the
    same weights and inputs, to 1e-4 relative (cuDNN picks its own convolution
    algorithms); a recurrent one over 6 steps with resets, and its ``unroll`` on the
    card against its steps there."""
    from baselines_tpu_torch.nn.networks import get_network

    gen = torch.Generator().manual_seed(5)
    cpu = get_network(name, ob_shape=shape, generator=gen)
    card = get_network(name, ob_shape=shape).to(dev)
    card.load_state_dict(cpu.state_dict())
    nsteps, nb = 6, 4
    if len(shape) == 3:
        xs = torch.randint(0, 256, (nsteps, nb) + shape, dtype=torch.uint8, generator=gen)
    else:
        xs = torch.randn((nsteps, nb) + shape, generator=gen)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    with torch.no_grad():
        if not cpu.is_recurrent:
            assert rel(card(xs[0].to(dev)), cpu(xs[0])) < 1e-4
            return
        masks = (torch.rand((nsteps, nb), generator=gen) < 0.3).float()
        c0 = 0.5 * torch.randn((nb, 2 * cpu.nlstm), generator=gen)
        c_cpu, c_card = c0, c0.to(dev)
        steps = []
        for t in range(nsteps):
            h_cpu, c_cpu = cpu(xs[t], c_cpu, masks[t])
            h_card, c_card = card(xs[t].to(dev), c_card, masks[t].to(dev))
            assert rel(h_card, h_cpu) < 1e-4 and rel(c_card, c_cpu) < 1e-4, t
            steps.append(h_card)
        seq, carry = card.unroll(xs.reshape((nsteps * nb,) + shape).to(dev), c0.to(dev),
                                 masks.to(dev))
    torch.testing.assert_close(seq, torch.cat(steps), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(carry, c_card, rtol=1e-5, atol=1e-6)


class _HostDraws:
    """Draws made on the CPU by one seeded generator and moved to ``device``, so that a
    run on the card and one on the CPU take the same numbers."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def uniform(self, shape, low, high):
        return (torch.rand(shape, generator=self.gen) * (high - low) + low).to(self.device)

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen).to(self.device)

    def randint(self, low, high, shape):
        return torch.randint(low, high, shape, generator=self.gen,
                             dtype=torch.int32).to(self.device)

    def permutation(self, n):
        return torch.randperm(n, generator=self.gen).to(self.device)


@pytest.mark.parametrize("network,dtype", [("mlp", torch.float32),
                                           ("cnn_s2d", torch.bfloat16)])
def test_trpo_fisher_vector_product_on_the_card_matches_the_cpu(dev, network, dtype):
    """trpo's double-backward Fisher-vector product on the card against the CPU on the
    same params, observations and vector: to 1e-4 relative for the f32 mlp; for the bf16
    cnn_s2d (cuDNN's double backward of the convolutions) finite, to 5e-2 relative."""
    from baselines_tpu_torch.algos.trpo import trpo
    from baselines_tpu_torch.envs.spaces import Box, Discrete
    from baselines_tpu_torch.nn.policy import build_policy

    gen = torch.Generator().manual_seed(3)
    if network == "mlp":
        ob_space, ob = Box(-1.0, 1.0, (4,)), torch.randn((256, 4), generator=gen)
    else:
        ob_space = Box(0, 255, (21, 21, 64), dtype="uint8")
        ob = torch.randint(0, 256, (64, 21, 21, 64), generator=gen, dtype=torch.uint8)
    kw = {} if network == "mlp" else {"dtype": dtype}
    cpu = build_policy(ob_space, Discrete(6), network, device="cpu", value_network="copy",
                       generator=torch.Generator().manual_seed(0), **kw)
    card = build_policy(ob_space, Discrete(6), network, device=dev, value_network="copy", **kw)
    card.module.load_state_dict(cpu.module.state_dict())
    out = []
    for pol, device in ((cpu, "cpu"), (card, dev)):
        theta = {k: p.detach() for k, p in trpo.split_params(pol.module)[0].items()}
        with torch.no_grad():
            old = trpo._PolicyHead(pol.module)(ob.to(device))
        n = sum(p.numel() for p in theta.values())
        v = torch.randn((n,), generator=torch.Generator().manual_seed(1)).to(device)
        out.append(trpo.fisher_vector_product(pol, theta, ob.to(device), old, 1e-3)(v).cpu())
    assert bool(torch.isfinite(out[1]).all())
    rel = float((out[1] - out[0]).abs().max() / out[0].abs().max())
    assert rel < (1e-4 if network == "mlp" else 5e-2), rel


def test_ddpg_train_steps_on_the_card_match_the_cpu(dev):
    """A ddpg cycle (40 rollout steps of 2 Pendulum envs, 5 train steps, OU noise, popart)
    on the card against the CPU from the same weights and draws: 5 row gathers a train
    step on the card, and every param to 1e-4 of its change."""
    from baselines_tpu_torch.algos.ddpg import ddpg
    from baselines_tpu_torch.ops.gather import take_rows

    import dataclasses

    from baselines_tpu_torch.algos.common import build_env

    kw = dict(nb_epochs=0, nb_rollout_steps=40,
              nb_train_steps=5, batch_size=16, noise_type="ou_0.2", normalize_returns=True,
              num_hidden=16, seed=0)
    runs = []
    for device in ("cpu", dev):
        venv = build_env("Pendulum-v1", 2, device=device, normalize=False)
        model = ddpg.learn(env=venv, device=device, **kw)
        draws = _HostDraws(7, device)
        obs, env_state = venv.reset(draws)
        state = dataclasses.replace(model.state, obs=obs, env_state=env_state)
        before = take_rows.launches
        state, losses = model.cycle(state, draws)
        launches = take_rows.launches - before
        runs.append((model, launches, losses))
    (cpu, cpu_launches, _), (card, card_launches, losses) = runs
    assert cpu_launches == 0 and card_launches == 5 * 5
    assert all(bool(torch.isfinite(x)) for x in losses)
    start = ddpg.learn(env=build_env("Pendulum-v1", 2, device="cpu", normalize=False),
                       device="cpu", **kw)
    for name, p in card.policy.module.state_dict().items():
        want = cpu.policy.module.state_dict()[name]
        base = start.policy.module.state_dict()[name]
        rel = float((p.cpu() - want).abs().max() / (want - base).abs().max().clamp_min(1e-12))
        assert rel < 1e-4, (name, rel)


def test_take_rows_kernel_on_her_buffer_rows(dev):
    """The her buffer's six reads a sample on the card: the flat (C * (T + 1), d) and
    (C * T, d) f32 rows gathered by the kernel, bit for bit the CPU sample from the same
    draws, 6 launches."""
    from baselines_tpu_torch.data.her_buffer import HerReplayBuffer
    from baselines_tpu_torch.envs.goal.point_reach import PointReach
    from baselines_tpu_torch.ops.gather import take_rows

    gen = torch.Generator().manual_seed(0)
    eps = [torch.randn((64, 51, 2), generator=gen), torch.randn((64, 51, 2), generator=gen),
           torch.randn((64, 50, 2), generator=gen), torch.randn((64, 50, 2), generator=gen)]
    out = []
    for device in ("cpu", dev):
        buf = HerReplayBuffer(10000, 50, {"o": 2, "g": 2, "u": 2})
        state = buf.init(device)
        draws = _HostDraws(1, device)
        state = buf.store_episodes(state, draws, *[x.to(device) for x in eps])
        before = take_rows.launches
        out.append(buf.sample(state, draws, 256, 4, PointReach().compute_reward))
        out.append(take_rows.launches - before)
    cpu, cpu_launches, card, card_launches = out
    assert cpu_launches == 0 and card_launches == 6
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k]), k


def test_kfac_preconditioned_gradient_from_cusolver_matches_the_cpu(dev):
    """acktr's K-FAC on the card: the factors' eigendecompositions by cuSOLVER's
    ``eigh`` against the CPU's on the same SPD factors with distinct eigenvalues (a
    513 x 513 A like a 512-unit layer's), compared through the preconditioned gradient,
    which does not depend on the eigenvectors' signs: to 1e-4 relative; the spectra
    clamped at 0."""
    from baselines_tpu_torch.algos.acktr import kfac

    gen = torch.Generator().manual_seed(0)
    layers = []
    for n_a, n_s in ((513, 6), (65, 64)):
        mats = []
        for n in (n_a, n_s):
            q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=torch.float64))
            lam = torch.linspace(0.05, 5.0, n, dtype=torch.float64)
            mats.append((q @ torch.diag(lam) @ q.T).to(torch.float32))
        layers.append(mats)
    grads = [(torch.randn((n_a - 1, n_s), generator=gen), torch.randn((n_s,), generator=gen))
             for (n_a, n_s) in ((513, 6), (65, 64))]
    out = []
    for device in ("cpu", dev):
        state = kfac.KFACState(layers=[
            kfac.LayerKFACState(A=a.to(device), S=s.to(device), QA=None, lamA=None, QS=None,
                                lamS=None) for a, s in layers], momentum=[])
        state = kfac.update_eigs(state)
        assert all(float(lay.lamA.min()) >= 0 and float(lay.lamS.min()) >= 0
                   for lay in state.layers)
        out.append([kfac.precondition_layer(lay, gW.to(device), gb.to(device), 0.01)
                    for lay, (gW, gb) in zip(state.layers, grads)])
    for (cw, cb), (gw, gb) in zip(*out):
        for c, g in ((cw, gw), (cb, gb)):
            assert bool(torch.isfinite(g).all())
            rel = float((g.cpu() - c).abs().max() / c.abs().max())
            assert rel < 1e-4, rel


def test_acer_train_chunk_on_the_card_matches_the_cpu(dev):
    """acer's train_chunk on the card against the CPU, from the same weights on the same
    (N = 16, T = 20) chunk of CartPole-shaped observations, with the trust region: each
    param's and each average param's change to 1e-4 of the CPU's change beside two ulps
    of the param, and finite metrics."""
    import copy

    import numpy as np

    from baselines_tpu_torch.algos.acer import acer
    from baselines_tpu_torch.algos.common import ClipRMSProp
    from baselines_tpu_torch.envs.spaces import Box, Discrete
    from baselines_tpu_torch.nn.policy import build_policy

    gen = torch.Generator().manual_seed(4)
    n, t, nact = 16, 20, 2
    mus = torch.softmax(torch.randn((n, t, nact), generator=gen), dim=-1)
    chunk = {"obs": torch.randn((n, t + 1, 4), generator=gen),
             "actions": torch.randint(0, nact, (n, t), generator=gen, dtype=torch.int32),
             "rewards": torch.ones((n, t)), "mus": mus,
             "dones": (torch.rand((n, t), generator=gen) < 0.05).to(torch.float32)}
    cpu = build_policy(Box(-1.0, 1.0, (4,)), Discrete(nact), "mlp", device="cpu",
                       estimate_q=True, generator=torch.Generator().manual_seed(0))
    start = copy.deepcopy(cpu.module.state_dict())
    runs = []
    for device in ("cpu", dev):
        pol = build_policy(Box(-1.0, 1.0, (4,)), Discrete(nact), "mlp", device=device,
                           estimate_q=True)
        pol.module.load_state_dict(start)
        avg = copy.deepcopy(pol.module)
        opt = ClipRMSProp(pol.module.parameters(), 10.0, decay=0.99, eps=1e-5)
        train = acer.make_train_chunk(pol, opt, nsteps=t, q_coef=0.5, ent_coef=0.01,
                                      gamma=0.99, c=10.0, trust_region=True, alpha=0.99,
                                      delta=1.0)
        metrics = train(avg, 7e-4, {k: v.to(device) for k, v in chunk.items()})
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        runs.append((pol.module.state_dict(), avg.state_dict()))
    for got_sd, want_sd in zip(runs[1], runs[0]):
        for name, want in want_sd.items():
            got = got_sd[name].cpu().double()
            delta = (want.double() - start[name].double()).abs().max()
            ulp = torch.from_numpy(np.spacing(want.abs().numpy())).double()
            assert float(delta) > 0, name
            assert bool(((got - want.double()).abs() <= 1e-4 * delta + 2 * ulp).all()), name


def test_take_rows_kernel_on_acer_flat_rows(dev):
    """acer's replay sample at Atari width: 16 rows of 592,704 bytes (21 stacked
    84 x 84 x 4 u8 frames, flat) out of a ring of 40, bit for bit x[idx], one launch."""
    from baselines_tpu_torch.ops.gather import take_rows

    gen = torch.Generator(device=dev).manual_seed(0)
    ring = torch.randint(0, 256, (40, 21 * 84 * 84 * 4), dtype=torch.uint8, device=dev,
                         generator=gen)
    idx = torch.randint(0, 40, (16,), device=dev, generator=gen)
    before = take_rows.launches
    got = take_rows(ring, idx)
    assert take_rows.launches == before + 1
    assert torch.equal(got, ring[idx])


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group on card 0 (torchrun's variables for rank 0 of 1, the
    rendezvous on a free local port), destroyed at the module's end."""
    import os
    import socket

    from baselines_tpu_torch.distributed import make_mesh, maybe_initialize_distributed

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    assert maybe_initialize_distributed()
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


MESH_RUNS = {
    "trpo": dict(env_id="CartPole-v1", num_envs=8, timesteps_per_batch=256,
                 total_timesteps=2 * 256, vf_iters=2),
    "ddpg": dict(env_id="Pendulum-v1", num_envs=4, nb_epochs=2, nb_epoch_cycles=1,
                 nb_rollout_steps=16, nb_train_steps=4, batch_size=32, noise_type="ou_0.2"),
    "her": dict(env_id="PointReach-v0", num_envs=4, total_timesteps=2 * 4 * 50, n_cycles=1,
                n_batches=4, batch_size=32, n_test_rollouts=4, num_hidden=32),
    "acktr": dict(env_id="DiscreteIdentity-v0", num_envs=8, nsteps=20,
                  total_timesteps=3 * 160, cold_iter=1, kfac_update=2),
    "acer": dict(env_id="CartPole-v1", network="mlp", num_envs=8, nsteps=8,
                 total_timesteps=4 * 64, replay_start=64, buffer_size=512, replay_ratio=2),
    "gail": dict(env_id="BoxIdentity-v0", num_envs=8, timesteps_per_batch=256,
                 total_timesteps=2 * 256, g_step=1, d_step=2, vf_iters=2),
}


@pytest.mark.parametrize("alg", list(MESH_RUNS))
def test_one_rank_nccl_mesh_run_equals_the_run_without(dev, nccl_mesh, alg, tmp_path):
    """Each of the six learners of the tenth slice, a few updates on the card with
    ``mesh=`` a one-rank NCCL mesh and without it, from one seed: the same kernel
    launches, and the params bit for bit (a one-rank all-reduce changes no value), or,
    where two runs without the mesh already differ, within that difference."""
    import numpy as np

    from baselines_tpu_torch.algos import get_learn_function
    from baselines_tpu_torch.core import logger
    from baselines_tpu_torch.distributed import param_consistency_check

    kwargs = dict(MESH_RUNS[alg])
    if alg == "gail":
        obs = np.random.RandomState(0).uniform(-1, 1, (1, 1000, 1)).astype(np.float32)
        np.savez(tmp_path / "expert.npz", obs=obs, acs=obs)
        kwargs["expert_path"] = str(tmp_path / "expert.npz")
    learn = get_learn_function(alg)

    def run(mesh):
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[])
        before = take_rows.launches, fused_cnn_forward.launches
        try:
            model = learn(seed=0, mesh=mesh, **kwargs)
        finally:
            logger.reset()
        torch.cuda.synchronize()
        launches = (take_rows.launches - before[0], fused_cnn_forward.launches - before[1])
        return model, {k: v.clone() for k, v in model.policy.module.state_dict().items()}, launches

    _, plain, plain_launches = run(None)
    model, meshed, launches = run(nccl_mesh)
    assert launches == plain_launches
    assert param_consistency_check(list(model.policy.module.parameters()), nccl_mesh, atol=0.0)

    def diff(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    d = diff(meshed, plain)
    if d != 0.0:
        assert d <= diff(run(None)[1], plain), (alg, d)
    assert all(bool(torch.isfinite(v).all()) for v in meshed.values())


class _AleStandIn:
    """A numpy stand-in for an ALE emulator at the ALE's frame size (210x160x3 u8) with
    Breakout's action meanings and lives, declaring the port's spaces (the card's
    machine has no gymnasium or ale_py)."""

    def __init__(self):
        import numpy as np

        from baselines_tpu_torch.envs.spaces import Box, Discrete

        self.observation_space = Box(0, 255, (210, 160, 3), np.uint8)
        self.action_space = Discrete(4)
        self.np_random = np.random.default_rng(0)
        self.ale, self.t, self._lives = self, 0, 5

    @property
    def unwrapped(self):
        return self

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "RIGHT", "LEFT"]

    def lives(self):
        return self._lives

    def _frame(self):
        import numpy as np

        y, x = np.mgrid[:210, :160]
        return np.stack([(x * 3 + self.t) % 256, (y * 5 + 7 * self.t) % 256,
                         (x * y + self.t) % 256], -1).astype(np.uint8)

    def reset(self, seed=None, **kwargs):
        import numpy as np

        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        self.t, self._lives = int(self.np_random.integers(0, 50)), 5
        return self._frame(), {}

    def step(self, action):
        self.t += 1 + int(action)
        self._lives -= int(self.t % 97 == 0)
        return self._frame(), float(self.t % 7 == 0), self._lives == 0, False, {}

    def close(self):
        pass


def _deepmind_stand_in():
    from baselines_tpu_torch.envs.atari import MaxAndSkipEnv, NoopResetEnv, wrap_deepmind

    return wrap_deepmind(MaxAndSkipEnv(NoopResetEnv(_AleStandIn(), noop_max=30), skip=4))


def test_atari_chain_in_a_forked_pool_on_the_card(dev):
    """The DeepMind chain with the numpy WarpFrame in 4 worker processes forked after
    CUDA is up, behind CallbackVecEnv on the card and VecFrameStack: the same frames,
    rewards and dones as the same chain in this process (HostDummyVecEnv) on the CPU,
    over 40 steps of the same actions."""
    import numpy as np

    from baselines_tpu_torch.envs.atari import atari_vec_env
    from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
    from baselines_tpu_torch.envs.gym_bridge import HostDummyVecEnv
    from baselines_tpu_torch.envs.vec import VecFrameStack

    torch.zeros(1, device=dev)  # CUDA is up before the fork
    card = atari_vec_env(_deepmind_stand_in, 4, 4, device=dev)
    cpu = VecFrameStack(CallbackVecEnv(HostDummyVecEnv([_deepmind_stand_in] * 4),
                                       device="cpu"), 4)
    try:
        obs_c, st_c = card.reset(_HostDraws(0, dev))
        obs_h, st_h = cpu.reset(_HostDraws(0, "cpu"))
        assert obs_c.device.type == dev.type and obs_c.dtype == torch.uint8
        assert obs_c.shape == (4, 84, 84, 4)
        assert torch.equal(obs_c.cpu(), obs_h)
        for a in np.random.RandomState(0).randint(0, 4, (40, 4)):
            obs_c, st_c, rew_c, done_c, _ = card.step(None, st_c, torch.from_numpy(a).to(dev))
            obs_h, st_h, rew_h, done_h, _ = cpu.step(None, st_h, torch.from_numpy(a))
            assert torch.equal(obs_c.cpu(), obs_h) and torch.equal(rew_c.cpu(), rew_h)
            assert torch.equal(done_c.cpu(), done_h)
    finally:
        card.close()
        cpu.close()


def test_segment_tree_on_the_card_matches_the_cpu(dev):
    """Sum and min trees of 2^16 leaves on the card against the same trees on the CPU:
    the trees after two batches of point sets, the range minima and the prefix-sum
    searches bit for bit, the range sums to 1e-6 relative."""
    import numpy as np

    from baselines_tpu_torch.data.segment_tree import MinSegmentTree, SumSegmentTree

    cap = 1 << 16
    rng = np.random.RandomState(0)
    for tree in (SumSegmentTree(cap), MinSegmentTree(cap)):
        s_dev, s_cpu = tree.init(dev), tree.init("cpu")
        for _ in range(2):
            idx = torch.from_numpy(rng.choice(cap, 1024, replace=False))
            vals = torch.from_numpy(rng.uniform(0, 4, 1024).astype(np.float32))
            s_dev, s_cpu = tree.set(s_dev, idx.to(dev), vals.to(dev)), tree.set(s_cpu, idx, vals)
        assert s_dev.tree.device.type == dev.type and torch.equal(s_dev.tree.cpu(), s_cpu.tree)
        for a in rng.randint(0, cap // 2, 8):
            got, want = float(tree.reduce(s_dev, int(a), int(a) + 5000)), float(
                tree.reduce(s_cpu, int(a), int(a) + 5000))
            assert got == want if tree.operation == "min" else abs(got - want) <= 1e-6 * abs(want)
        if tree.operation == "sum":
            q = torch.from_numpy(rng.uniform(0, float(s_cpu.tree[1]), 512).astype(np.float32))
            assert torch.equal(tree.find_prefixsum_idx(s_dev, q.to(dev)).cpu(),
                               tree.find_prefixsum_idx(s_cpu, q))


def test_api_defaults_and_samples_on_the_card(dev):
    """With no device argument, ExpertDataset, RunningMeanStd.create and
    RecurrentNetwork.initial_state put their tensors on the card; each space's sample
    from a Draws on the card is a tensor there, in its space; a Q-policy's mode_step
    ignores a carry and a mask."""
    import numpy as np

    from baselines_tpu_torch.algos.dqn.dqn import QNet, QPolicy
    from baselines_tpu_torch.algos.gail.dataset import ExpertDataset
    from baselines_tpu_torch.core.rng import Draws
    from baselines_tpu_torch.core.running_stats import RunningMeanStd
    from baselines_tpu_torch.envs import spaces
    from baselines_tpu_torch.nn.networks import get_network

    obs = np.zeros((5, 3), np.float32)
    assert ExpertDataset(obs=obs, acs=obs).obs.device.type == "cuda"
    assert RunningMeanStd.create((3,)).mean.device.type == "cuda"
    lstm = get_network("lstm", ob_shape=(3,), nlstm=4)
    assert lstm.initial_state(2).device.type == "cuda"
    draws = Draws(0, dev)
    for space in (spaces.Discrete(5), spaces.Box(-1.0, 1.0, (3,)), spaces.MultiBinary(4),
                  spaces.Box(-np.inf, np.inf, (2,)), spaces.MultiDiscrete([2, 9])):
        for _ in range(100):
            x = space.sample(draws)
            assert x.device.type == "cuda" and space.contains(x), space
    goal = spaces.DictSpace({"b": spaces.MultiBinary(2), "a": spaces.Discrete(3)})
    assert list(goal.sample(draws)) == ["a", "b"]
    policy = QPolicy(QNet(get_network("mlp", ob_shape=(4,)), 3).to(dev),
                     spaces.Box(-1.0, 1.0, (4,)), 3)
    x = torch.randn((8, 4), device=dev)
    action, q = policy.mode_step(x, None, torch.ones((8, 6), device=dev),
                                 torch.ones(8, device=dev))
    assert policy.initial_state(8) is None
    assert torch.equal(action, policy.mode_step(x)[0]) and torch.equal(q, policy.mode_step(x)[1])
