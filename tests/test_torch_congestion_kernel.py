"""The JRBA congestion kernel's host side, on the CPU: the per-link slot
lists the CUDA kernel scatters through, the wrapper's plain version against
the reference's Pallas chunk driver (interpret mode), and the rule that a
CUDA engine never runs on the host by default. The kernel itself runs in
``test_torch_kernels_gpu.py`` on a card."""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.jrba import _finalize as ref_finalize
from repro.kernels.jrba_congestion import sparse_congestion_solve as ref_pallas_solve
from repro_torch.core.jrba import _finalize as port_finalize
from repro_torch.core.jrba import _link_slots, _stacked_csr
from repro_torch.kernels import jrba_congestion as jc

K = 3
N_ITERS = 150


def _programs(name, n_sets=8, n_flows=4, seed=3):
    """Same-bucket program pairs (reference, port): the largest group of one
    (Nf, K, La_pad, Pmax) shape among random flow sets."""
    rnet, _ = ref.SCENARIOS[name].build(seed=0, n_jobs=4)
    pnet, _ = port.SCENARIOS[name].build(seed=0, n_jobs=4)
    pairs = [
        (ref.build_program(rnet, a, k=K), port.build_program(pnet, b, k=K))
        for a, b in zip(
            ref.random_flow_sets(rnet, n_sets, n_flows, seed=seed),
            port.random_flow_sets(pnet, n_sets, n_flows, seed=seed),
        )
    ]
    key = lambda p: (p.valid.shape, p.la_pad, p.ridx.shape[-1])  # noqa: E731
    keys = [key(p) for _, p in pairs]
    top = max(keys, key=keys.count)
    return [pair for pair, kk in zip(pairs, keys) if kk == top]


@pytest.mark.parametrize("name", sorted(port.SCENARIOS))
def test_link_slot_lists_cover_every_slot_once_in_order(name):
    """Every non-sentinel (i, k, p) entry of ridx appears exactly once in its
    link's list; lists are ascending in the flattened i*K + k slot, so the
    kernel's summation order is a function of the program alone."""
    net, _ = port.SCENARIOS[name].build(seed=0, n_jobs=4)
    for fs in port.random_flow_sets(net, 3, 6, seed=5):
        prog = port.build_program(net, fs, k=K)
        nf, k, _ = prog.ridx.shape
        la = prog.la_pad
        ptr, slot = prog.csr_ptr, prog.csr_slot
        assert ptr.dtype == slot.dtype == np.int32
        assert ptr[0] == 0 and ptr[-1] == len(slot) == int((prog.ridx < la).sum())
        assert np.all(np.diff(ptr) >= 0)
        for l in range(la):
            got = slot[ptr[l] : ptr[l + 1]]
            want = np.flatnonzero((prog.ridx == l).any(axis=-1).reshape(nf * k))
            np.testing.assert_array_equal(got, want)
        # usage rebuilt from the lists is the active-compressed usage
        usage = np.zeros((nf * k, la), dtype=np.float32)
        for l in range(la):
            usage[slot[ptr[l] : ptr[l + 1]], l] += 1.0
        np.testing.assert_array_equal(usage.reshape(nf, k, la), prog.usage_active)
        p2, s2 = _link_slots(prog.ridx, la)
        np.testing.assert_array_equal(p2, ptr)
        np.testing.assert_array_equal(s2, slot)


def test_stacked_slot_lists_offset_per_lane():
    progs = [p for _, p in _programs("edge-mesh")]
    ptr, slot = _stacked_csr(progs)
    off = 0
    for b, p in enumerate(progs):
        np.testing.assert_array_equal(ptr[b], p.csr_ptr + off)
        np.testing.assert_array_equal(slot[ptr[b, 0] : ptr[b, -1]], p.csr_slot)
        off += len(p.csr_slot)
    assert ptr[-1, -1] == len(slot)


def _inputs(progs):
    ptr, slot = _stacked_csr(progs)
    return [
        torch.from_numpy(np.stack([p.ridx for p in progs])),
        torch.from_numpy(np.stack([p.valid for p in progs])),
        torch.from_numpy(np.stack([p.volumes for p in progs])),
        torch.from_numpy(np.stack([p.capacity_active() for p in progs])),
        torch.tensor([float(len(p.capacity) - p.la_pad) for p in progs]),
        torch.from_numpy(ptr),
        torch.from_numpy(slot),
    ]


@pytest.mark.parametrize("name", ("edge-mesh", "wan-mesh", "fat-tree"))
def test_plain_version_matches_reference_pallas_driver(name):
    """The wrapper on CPU tensors runs the plain version, without touching
    the kernel; it rounds like the reference's Pallas chunk driver."""
    pairs = _programs(name)
    assert len(pairs) >= 2
    before = jc.sparse_congestion_solve.launches
    w, span, steps = jc.sparse_congestion_solve(*_inputs([p for _, p in pairs]), n_iters=N_ITERS)
    assert jc.sparse_congestion_solve.launches == before
    assert w.dtype == span.dtype == torch.float32 and steps.dtype == torch.int32
    r = [rp for rp, _ in pairs]
    rw, rspan, _ = ref_pallas_solve(
        np.stack([p.ridx for p in r]),
        np.stack([p.valid for p in r]),
        np.stack([p.volumes for p in r]),
        np.stack([p.capacity_active() for p in r]),
        np.array([len(p.capacity) - p.la_pad for p in r], dtype=np.float32),
        n_iters=N_ITERS,
        interpret=True,
    )
    for i, (rp, pp) in enumerate(pairs):
        m_p = w[i].numpy() * pp.volumes[:, None]
        m_r = np.asarray(rw[i]) * rp.volumes[:, None]
        a = port_finalize(pp, m_p, float(span[i]))
        b = ref_finalize(rp, m_r, float(rspan[i]))
        assert a.routes == b.routes and a.span == b.span
        np.testing.assert_array_equal(a.bandwidth, b.bandwidth)
        # the certificate is held to the reference's own jnp-vs-Pallas
        # tolerance (worst measured gap here: 3.4%)
        assert float(span[i]) == pytest.approx(float(rspan[i]), rel=5e-2)


def _stream_pairwise(values):
    """The kernel's PairwiseSum: adjacent pairs first, streamed with a stack
    of pending power-of-two partial sums."""
    stack = {}
    for n, x in enumerate(values):
        level = 0
        while n & 1:
            x = stack.pop(level) + x
            n >>= 1
            level += 1
        stack[level] = x
    acc = None
    for level in sorted(stack):
        acc = stack[level] if acc is None else stack[level] + acc
    return np.float32(0) if acc is None else acc


def _warp_block_sum(values, threads):
    """The kernel's block_sum: xor butterflies within each warp, then a
    butterfly over the warp totals (zero beyond the last warp)."""
    x = np.zeros(threads, dtype=np.float32)
    x[: len(values)] = values

    def butterfly(lanes):
        for off in (16, 8, 4, 2, 1):
            lanes = np.array([lanes[i] + lanes[i ^ off] for i in range(32)], dtype=np.float32)
        return lanes[0]

    totals = [butterfly(x[w : w + 32]) for w in range(0, threads, 32)]
    return butterfly(np.array(totals + [0.0] * (32 - len(totals)), dtype=np.float32))


def test_plain_sums_follow_the_kernel_order():
    """The plain version's tensor reductions give, bit for bit, the sums the
    kernel's per-thread code computes (float32, random magnitudes)."""
    from repro_torch.kernels.jrba_congestion import _link_sum, _pairwise_sum

    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 5, 7, 8, 13, 31, 64, 100):
        vals = (rng.lognormal(0, 3, n)).astype(np.float32)
        width = 1
        while width < n:
            width *= 2
        padded = np.zeros(2 * width, dtype=np.float32)
        padded[:n] = vals
        got = _pairwise_sum(torch.from_numpy(padded)[None]).numpy()[0]
        assert got == _stream_pairwise(list(vals)), n
    for la in (8, 21, 32, 33, 64, 100, 256):
        vals = (rng.lognormal(0, 3, la)).astype(np.float32)
        got = _link_sum(torch.from_numpy(vals)[None]).numpy()[0]
        threads = -(-la // 32) * 32
        assert got == _warp_block_sum(vals, threads), la
        assert got == _warp_block_sum(vals, max(threads, 256)), la  # idle warps add zeros


def test_plain_batch_lanes_are_independent():
    """No operation mixes lanes: each lane of a batch is its B == 1 result
    bit for bit, whatever else shares the batch."""
    progs = [p for _, p in _programs("fat-tree")]
    w, span, steps = jc.sparse_congestion_plain(*_inputs(progs), n_iters=N_ITERS)
    for i, prog in enumerate(progs):
        w1, span1, steps1 = jc.sparse_congestion_plain(*_inputs([prog]), n_iters=N_ITERS)
        assert torch.equal(w[i], w1[0]) and span[i] == span1[0] and steps[i] == steps1[0]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """Without a usable card the default engine raises instead of running on
    the host; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net, arrivals = port.SCENARIOS["edge-mesh"].build(seed=0, n_jobs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.JRBAEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.OnlineScheduler(net, "OTFS")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.jrba(net, port.random_flow_sets(net, 1, 2, seed=0)[0])
    eng = port.JRBAEngine(device="cpu")
    assert eng.device.type == "cpu" and eng.solver == "sparse"
    assert port.OnlineScheduler(net, "OTFS", device="cpu").engine.device.type == "cpu"


def test_wrapper_rejects_other_devices():
    progs = [p for _, p in _programs("edge-mesh")]
    args = [t.to("meta") for t in _inputs(progs)]
    with pytest.raises(ValueError, match="unsupported device"):
        jc.sparse_congestion_solve(*args, n_iters=N_ITERS)


def test_kernel_limits_cover_the_scheduler_shapes():
    """The largest programs the scheduler's buckets produce (Nf 64, K 4,
    La 256) fit a staged block: its threads and its shared memory."""
    assert jc._threads(64, 256) <= jc.STAGED_THREADS
    assert jc.kernel_smem_bytes(64, 4, 256, 16, 400) <= jc.MAX_SMEM
    assert jc.launch_plan(64, 64, 4, 16, 256, 400)["staged"]
    assert jc._threads(8, 21) == 32


def _kernel_pairwise(values, chunk):
    """The kernel's ``pairwise<CW>``: trees of ``chunk`` values (zeros past
    the end), their totals streamed through a stack of pending sums."""
    values = np.asarray(values, dtype=np.float32)
    n = len(values)
    nch = -(-n // chunk)
    stack = {}
    for c in range(nch):
        v = np.zeros(chunk, dtype=np.float32)
        v[: min(chunk, n - c * chunk)] = values[c * chunk : (c + 1) * chunk]
        while len(v) > 1:
            v = v[0::2] + v[1::2]
        x, level = v[0], 0
        while (c >> level) & 1:
            x = stack.pop(level) + x
            level += 1
        stack[level] = x
    acc = None
    for level in sorted(stack):
        acc = stack[level] if acc is None else stack[level] + acc
    return np.float32(0) if acc is None else acc


@pytest.mark.parametrize("name", sorted(port.SCENARIOS))
def test_kernel_staged_tables_sum_in_the_plain_order(name):
    """What the kernel stages from a program and sums, in its order, gives
    the plain version's bits: each link's slot list (trees of 8, streamed)
    against the padded slot table, and each path's hops in the (k, p, row)
    table padded to the hop width with the sentinel (a zero gradient)
    against the gather over ridx."""
    from repro_torch.kernels.jrba_congestion import _pairwise_sum, _slot_table

    net, _ = port.SCENARIOS[name].build(seed=0, n_jobs=4)
    rng = np.random.default_rng(0)
    for fs in port.random_flow_sets(net, 3, 8, seed=9):
        prog = port.build_program(net, fs, k=K)
        nf, k, p = prog.ridx.shape
        la, nk = prog.la_pad, nf * k
        vw = rng.lognormal(0, 3, nk).astype(np.float32)
        table = _slot_table(torch.from_numpy(prog.csr_ptr)[None],
                            torch.from_numpy(prog.csr_slot), nk)[0]
        want = _pairwise_sum(torch.cat([torch.from_numpy(vw), torch.zeros(1)])[table]).numpy()
        for l in range(la):
            slots = prog.csr_slot[prog.csr_ptr[l] : prog.csr_ptr[l + 1]]
            assert _kernel_pairwise(vw[slots], 8) == want[l], (name, l)
        glink = np.append(rng.lognormal(0, 3, la).astype(np.float32), np.float32(0))
        width = jc.hop_width(p)
        hops = np.full((k, max(p, width), nf), la, dtype=np.int64)
        hops[:, :p, :] = prog.ridx.transpose(1, 2, 0)
        want = _pairwise_sum(torch.from_numpy(glink)[torch.from_numpy(prog.ridx).long()]).numpy()
        for i in range(nf):
            for kk in range(k):
                vals = glink[hops[kk, :, i]]
                assert _kernel_pairwise(vals, min(width, len(vals))) == want[i, kk], (name, i)


def test_launch_plan_raises_on_shapes_the_kernel_does_not_take():
    """The wrapper's launch plan: one-warp lanes up to 32 rows and links,
    hop widths 4, 8, 16 (longer paths in 16-hop trees), and a ValueError
    for K outside 1..8, an empty problem or more than 1024 threads."""
    plan = jc.launch_plan(64, 8, 3, 4, 8, 400)
    assert plan == {"threads": 32, "smem": jc.kernel_smem_bytes(8, 3, 8, 4, 400),
                    "hop_width": 4, "staged": True, "workspace": 0}
    assert jc.launch_plan(4, 40, 4, 16, 64, 400)["threads"] == 64
    assert [jc.hop_width(p) for p in (1, 4, 5, 8, 9, 16, 32)] == [4, 4, 8, 8, 16, 16, 16]
    assert [jc.k_width(k) for k in range(1, 9)] == [3, 3, 3, 4, 8, 8, 8, 8]
    for bad in (
        dict(K=0), dict(K=9), dict(Nf=1025), dict(La=1100), dict(B=0), dict(n_iters=0),
    ):
        shape = dict(B=4, Nf=8, K=3, P=4, La=8, n_iters=400) | bad
        with pytest.raises(ValueError):
            jc.launch_plan(**shape)


@pytest.mark.parametrize("shape", [
    dict(Nf=513), dict(La=600), dict(Nf=1024, K=8, P=32, La=1024), dict(n_iters=20000),
    dict(Nf=512, K=8, P=32),
])
def test_launch_plan_takes_the_general_instance_beyond_staging(shape):
    """Lanes of 513-1024 threads, or whose schedule and tables exceed a
    block's shared memory, run on the general instance: its shared memory
    (step hand-offs and the rows' state) fits, and its tables go to a
    workspace of ``table_bytes`` a lane."""
    shape = dict(B=4, Nf=8, K=3, P=4, La=8, n_iters=400) | shape
    plan = jc.launch_plan(**shape)
    nf, k, p, la = shape["Nf"], shape["K"], shape["P"], shape["La"]
    assert not plan["staged"]
    assert plan["threads"] == jc._threads(nf, la) <= jc.MAX_THREADS
    assert plan["smem"] == jc.kernel_smem_bytes(nf, k, la, p, shape["n_iters"], staged=False)
    assert plan["smem"] <= jc.MAX_SMEM
    assert plan["workspace"] == jc.table_bytes(nf, k, p)


def _kernel_div_rn(a, b):
    """The kernel's ``div_rn`` in float32: a zero dividend's signed zero, a
    tiny one scaled by 2^64 and the quotient back by 2^-64 while it stays
    normal, else the division itself."""
    a, b = np.float32(a), np.float32(b)
    tiny = abs(a) < np.float32(2.0**-64)
    zero = a == 0 and b == b and b != 0
    q = (np.float32(1) if zero else a * np.float32(2.0**64) if tiny else a) / b
    r = np.copysign(np.float32(0), a) * np.sign(b) if zero else (
        q * np.float32(2.0**-64) if tiny else q)
    if tiny and not zero and abs(q) < np.float32(2.0**-62):
        r = a / b
    return r


def test_kernel_division_matches_ieee_bit_for_bit():
    """Scaling a tiny dividend by 2^64 and its quotient back is exact while
    the quotient is normal: the kernel's division gives IEEE's bits on
    random, tiny, denormal and signed-zero dividends over the divisors the
    kernel meets (capacities, temperatures, Adam's corrections, sums)."""
    rng = np.random.default_rng(0)
    exps = rng.uniform(-149, 20, 20000)
    a = (rng.choice([-1.0, 1.0], 20000) * 2.0**exps).astype(np.float32)
    a[:8] = [0.0, -0.0, 2.0**-149, -(2.0**-149), 2.0**-126, 2.0**-64, 2.0**-65, 1e-45]
    b = (2.0 ** rng.uniform(-30, 40, 20000)).astype(np.float32)
    with np.errstate(under="ignore"):
        for x, y in zip(a, b):
            want = x / y
            got = _kernel_div_rn(x, y)
            assert got.view(np.int32) == want.view(np.int32), (x, y, got, want)
