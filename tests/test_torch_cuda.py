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
