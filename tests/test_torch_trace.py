"""The port's spans (``kmer_hasher_tpu_torch/utils/trace.py``) under
``torch.profiler`` on the CPU: which ``kmh.*`` ranges each flow records,
how they nest, that none is open across a ``yield``, and that outputs are
bitwise the same with the profiler on and off. Then the benchmark's reading
of them (``port_bench/spans.py``) on synthetic traces, whose every number
is known, and the file entry's ``flagged_reads`` in ``store.timings``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.utils import trace
from port_bench import run as bench_run
from port_bench import spans
from port_bench.trace import WINDOW, Trace, idle_share

CPU = "cpu"
K = 15
MIN_Q = 0  # the f32 filter flags reads of these qualities at q0
METRICS = ("stage_idle_share", "batch_idle_share", "tier_merge_device_share",
           "idle_outside_program.count", "build_share",
           "query_dispatch_idle_share", "idle_outside_program.query",
           "query_launches")

# the innermost program span each span may sit in (None: no program span)
PARENTS = {
    "kmh.count": {None},
    "kmh.count.stage": {"kmh.count"},
    "kmh.count.batch": {"kmh.count"},
    "kmh.count.sweep": {"kmh.count"},
    "kmh.io.wait": {"kmh.count"},
    "kmh.store.tier_merge": {"kmh.count.batch", "kmh.count.sweep",
                             "kmh.store.fold"},
    "kmh.store.spill": {"kmh.count.batch", "kmh.count.sweep",
                        "kmh.store.fold"},
    "kmh.store.fold": {"kmh.count", "kmh.store.spectrum"},
    "kmh.store.rejoin": {"kmh.store.fold"},
    "kmh.store.spectrum": {None},
    "kmh.index.build": {None},
    "kmh.index.encode": {"kmh.index.build"},
    "kmh.index.sort": {"kmh.index.build"},
    "kmh.index.groups": {"kmh.index.build"},
    "kmh.index.tables": {None},
    "kmh.index.pairs": {None, "kmh.index.tables"},
    "kmh.query": {None},
    "kmh.query.ranges": {"kmh.query"},
    "kmh.query.total": {"kmh.query"},
    "kmh.query.hits": {"kmh.query"},
}


def read_batch(seed: int, rows: int, width: int = 64):
    """Host (seq, qual, lengths, has_qual) reads of uniform bases,
    qualities Q2-Q40 with one in ten Q0-Q6: the hybrid filter flags a few
    at ``MIN_Q``."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, width))]
    qual = rng.integers(35, 74, (rows, width)).astype(np.uint8)
    low = rng.random(qual.shape) < 0.1
    qual[low] = rng.integers(33, 40, int(low.sum())).astype(np.uint8)
    lengths = rng.integers(K - 3, width + 1, rows).astype(np.int32)
    return seq.copy(), qual, lengths, np.ones(rows, bool)


def write_fastq(path, batches) -> str:
    out = []
    for seq, qual, lengths, _hq in batches:
        for i, n in enumerate(lengths.tolist()):
            out.append(b"@r\n%s\n+\n%s\n" % (seq[i, :n].tobytes(),
                                             qual[i, :n].tobytes()))
    path.write_bytes(b"".join(out))
    return str(path)


def sequence(seed: int, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    s[1000:1400] = s[200:600]  # a repeat, so that pairs exist
    return s


def count_flow(_tmp):
    st = api.CountStore(K, device=CPU, spill_bytes=60_000)
    stats: dict = {}
    counting.count_batches(st, [read_batch(s, 40) for s in range(6)], K,
                           min_q=MIN_Q, exact_ll="hybrid", stats=stats)
    return (st.keys.numpy(), st.cnt.numpy(), api.kmer_spectrum(st, 40),
            stats["flagged_reads"])


def file_flow(tmp):
    path = write_fastq(tmp / "r.fq", [read_batch(s, 30) for s in range(3)])
    st = api.count_kmers_fq_sh_rp(path, K, min_q=MIN_Q, exact_ll="hybrid",
                                  batch_rows=32, device=CPU)
    return st.keys.numpy(), st.cnt.numpy(), api.kmer_spectrum(st, 40)


def index_flow(_tmp):
    ix = api.make_kmer_hash(sequence(1), 9, device=CPU)
    tabs = api.kmer_pos(ix, 15)
    return ([tabs["kmer"], tabs["pos"].numpy(), tabs["pair.pos"].numpy(),
             tabs["count"].numpy()]
            + [c.numpy() for c in ix.iter_pair_chunks(500)])


def query_flow(_tmp):
    seq = sequence(2)
    ix = api.make_kmer_hash(seq, 11, device=CPU)
    return api.seq_kmer_pos(ix, seq[150:1700], 11).numpy()


FLOWS = {
    "count": (count_flow, {"kmh.count", "kmh.count.stage", "kmh.count.batch",
                           "kmh.count.sweep", "kmh.store.tier_merge",
                           "kmh.store.spill", "kmh.store.fold",
                           "kmh.store.rejoin", "kmh.store.spectrum"}),
    "file": (file_flow, {"kmh.count", "kmh.io.wait", "kmh.count.stage",
                         "kmh.count.batch", "kmh.count.sweep",
                         "kmh.store.fold", "kmh.store.spectrum"}),
    "index": (index_flow, {"kmh.index.build", "kmh.index.encode",
                           "kmh.index.sort", "kmh.index.groups",
                           "kmh.index.tables", "kmh.index.pairs"}),
    "query": (query_flow, {"kmh.index.build", "kmh.query",
                           "kmh.query.ranges", "kmh.query.total",
                           "kmh.query.hits"}),
}


def traced(fn, *args) -> tuple:
    """``fn(*args)`` under the profiler inside a window span: its result
    and the window's trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            out = fn(*args)
    return out, Trace(prof)


def program_spans(tr: Trace):
    return [(a, b, n) for a, b, n in tr.host if n.startswith(spans.PREFIX)]


def innermost(ranges, a: int, b: int):
    """The innermost range of ``ranges`` holding [a, b) (not itself)."""
    best = None
    for x, y, n in ranges:
        if x <= a and b <= y and (x, y) != (a, b):
            if best is None or (x, -y) > (best[0], -best[1]):
                best = (x, y, n)
    return best


def same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def test_a_span_with_the_profiler_off_is_the_one_shared_no_op():
    a, b = trace.span("kmh.count"), trace.span("kmh.query.hits")
    assert a is b is trace.OFF
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("kmh.count")
        assert on is not trace.OFF
        with on:
            pass
    assert trace.span("kmh.count") is trace.OFF


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_flows_record_their_spans_nested_as_the_layers_are(flow, tmp_path):
    fn, names = FLOWS[flow]
    _out, tr = traced(fn, tmp_path)
    ranges = program_spans(tr)
    assert names <= {n for _a, _b, n in ranges}
    for a, b, n in ranges:
        assert n in PARENTS, n
        parent = innermost(ranges, a, b)
        assert (parent[2] if parent else None) in PARENTS[n], (n, parent)


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_outputs_are_bitwise_the_same_with_the_profiler_on(flow, tmp_path):
    fn, _names = FLOWS[flow]
    off = fn(tmp_path)
    on, _tr = traced(fn, tmp_path)
    assert same(off, on)


def _stage_items(tmp):
    return counting._device_batches([read_batch(s, 8) for s in range(4)],
                                    torch.device(CPU))


def _file_items(tmp):
    path = write_fastq(tmp / "w.fq", [read_batch(s, 20) for s in range(3)])
    return counting._iter_file_batches(path, None, batch_rows=16)


def _pair_items(_tmp):
    return api.make_kmer_hash(sequence(3), 9, device=CPU).iter_pair_chunks(
        300)


def _hit_items(_tmp):
    seq = sequence(4)
    return api.iter_seq_kmer_pos_chunks(
        api.make_kmer_hash(seq, 9, device=CPU), seq[100:1800], 9, 200)


@pytest.mark.parametrize("items", [_stage_items, _file_items, _pair_items,
                                   _hit_items])
def test_no_span_is_open_across_a_yield(items, tmp_path):
    """The consumer's work between a generator's items lies in no program
    span: each item's span closes before the item is handed out."""
    def consume():
        n = 0
        for _item in items(tmp_path):
            with record_function("test.consumer"):
                n += 1
        return n

    n, tr = traced(consume)
    mine = [h for h in tr.host if h[2] == "test.consumer"]
    assert len(mine) == n >= 2
    ranges = program_spans(tr)
    assert ranges
    for a, b, _n in mine:
        assert not any(x < b and a < y for x, y, _p in ranges)


def spilled_store(dev, fold_budget_bytes=None) -> api.CountStore:
    """A store whose runs spill to host memory, with its adds pending."""
    st = api.CountStore(21, device=dev, spill_bytes=4096,
                        fold_budget_bytes=fold_budget_bytes)
    st.run_build_size = 1 << 9
    rng = np.random.default_rng(8)
    pool = rng.integers(0, 1 << 42, size=4000, dtype=np.int64)
    for _ in range(8):
        raw = pool[rng.integers(0, pool.size, size=1500)]
        st.add_kmers(torch.from_numpy(raw), torch.ones(raw.size, dtype=bool),
                     defer=True)
    return st


def test_a_fold_with_nothing_spilled_opens_no_rejoin():
    """Without a spill the fold neither opens ``kmh.store.rejoin`` nor adds
    to its counters."""
    st = api.CountStore(21, device=CPU)
    raw = np.random.default_rng(9).integers(0, 1 << 42, size=3000,
                                            dtype=np.int64)
    st.add_kmers(torch.from_numpy(raw), torch.ones(raw.size, dtype=bool))
    _out, tr = traced(st.flush)
    names = {n for _a, _b, n in program_spans(tr)}
    assert "kmh.store.fold" in names and "kmh.store.rejoin" not in names
    assert st.timings["rejoin_s"] == 0.0 and st.timings["rejoined_rows"] == 0


@pytest.mark.parametrize("budget", [None, 4096])
def test_rejoin_opens_inside_the_fold(budget):
    """``kmh.store.rejoin`` opens once a fold, inside ``kmh.store.fold``,
    for the plain rejoin (runs back one at a time) and the ranged one."""
    st = spilled_store(CPU, budget)
    assert len(st._spilled) >= 2
    _out, tr = traced(st.flush)
    ranges = program_spans(tr)
    rejoins = [r for r in ranges if r[2] == "kmh.store.rejoin"]
    assert len(rejoins) == 1
    assert innermost(ranges, *rejoins[0][:2])[2] == "kmh.store.fold"
    for a, b, n in ranges:
        assert n in PARENTS, n
    tm = st.timings
    assert tm["ranged_folds"] == (budget is not None)
    assert tm["rejoined_rows"] == tm["spilled_rows"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 4096])
def test_staging_bytes_are_the_rows_spilled_and_rejoined(cuda, budget):
    """On a card every byte of a spill and of a rejoin goes through the
    pinned staging buffers once, and the table is the CPU store's."""
    st = spilled_store(cuda, budget)
    cpu = spilled_store(CPU)
    st.flush(), cpu.flush()
    torch.cuda.synchronize()
    tm = st.timings
    assert tm["spills"] >= 2 and tm["ranged_folds"] == (budget is not None)
    assert tm["rejoined_rows"] == tm["spilled_rows"] > 0
    assert tm["staging_bytes"] == 16 * (tm["spilled_rows"]
                                        + tm["rejoined_rows"])
    assert tm["staging_s"] > 0
    assert torch.equal(st.keys.cpu(), cpu.keys)
    assert torch.equal(st.cnt.cpu(), cpu.cnt)


# -- port_bench/spans.py on synthetic traces (nanoseconds) -----------------

def synthetic(with_spans: bool = True, with_device: bool = True):
    """A 100 ns window: kmh.count [10, 90) holding kmh.count.batch
    [20, 50), which holds kmh.store.tier_merge [30, 40), and
    kmh.count.stage [60, 70); kernels [25, 45) and [80, 85), a copy
    [44, 65) and a fill [5, 8); six launch calls."""
    ev = [(WINDOW, False, 0, 100), ("port_bench.job", False, 2, 98),
          ("aten::copy_", False, 60, 69)]
    if with_spans:
        ev += [("kmh.count", False, 10, 90),
               ("kmh.count.batch", False, 20, 50),
               ("kmh.store.tier_merge", False, 30, 40),
               ("kmh.count.stage", False, 60, 70)]
    ev += [("cudaLaunchKernel", False, t, t + 1) for t in (21, 31, 32, 61,
                                                           95)]
    ev += [("cuLaunchKernelEx", False, 35, 36)]
    if with_device:
        ev += [("k1", True, 25, 45), ("Memcpy HtoD (Pinned -> Device)", True,
                                      44, 65),
               ("k2", True, 80, 85), ("Memset (Device)", True, 5, 8)]
    return Trace(events=ev)


WANT = {  # ns, or launch calls, by hand from the picture above
    "kmh.count": dict(host_s=80, self_s=40, idle_s=25, kernel_s=25,
                      launches=5, n=1),
    "kmh.count.batch": dict(host_s=30, self_s=20, idle_s=5, kernel_s=20,
                            launches=4, n=1),
    "kmh.store.tier_merge": dict(host_s=10, self_s=10, idle_s=0,
                                 kernel_s=10, launches=3, n=1),
    "kmh.count.stage": dict(host_s=10, self_s=10, idle_s=5, kernel_s=0,
                            launches=1, n=1),
    spans.OUTSIDE: dict(host_s=20, self_s=20, idle_s=17, kernel_s=0,
                        launches=1, n=0),
}


def as_ns(row: dict) -> dict:
    return {f: (round(v * 1e9) if f.endswith("_s") else v)
            for f, v in row.items()}


def test_span_table_of_nested_spans_and_overlapping_activities():
    t = spans.span_table(synthetic())
    assert {n: as_ns(r) for n, r in t.items()} == WANT


def test_metric_files_read_the_table():
    ctx = {"trace": synthetic(), "trace_jobs": [{"wall_s": 80e-9}]}
    got = {m: bench_run.load_module(bench_run.HERE / "metrics" / f"{m}.py")
           .read(ctx) for m in METRICS}
    assert got["stage_idle_share"] == pytest.approx(5.0)
    assert got["batch_idle_share"] == pytest.approx(5.0)
    assert got["tier_merge_device_share"] == pytest.approx(12.5)
    assert got["idle_outside_program.count"] == pytest.approx(17.0)
    assert got["idle_outside_program.query"] == pytest.approx(17.0)
    assert got["build_share"] is None  # no index span in this trace
    assert got["query_dispatch_idle_share"] is None
    assert got["query_launches"] is None


@pytest.mark.parametrize("spans_on,device_on", [(False, True),
                                                (True, False)])
def test_no_program_span_or_no_device_reads_nothing(spans_on, device_on):
    """A program without spans (the benchmark's older commits) or a CPU
    run: every metric gives nothing, and none raises."""
    ctx = {"trace": synthetic(spans_on, device_on),
           "trace_jobs": [{"wall_s": 80e-9}]}
    assert spans.span_table(ctx["trace"]) is None
    for m in METRICS:
        mod = bench_run.load_module(bench_run.HERE / "metrics" / f"{m}.py")
        assert mod.read(ctx) is None, m


def random_trace(seed: int) -> Trace:
    """Nested program spans (some named alike, some past the window's
    edges), other host events, launches and overlapping device
    activities, at random."""
    rng = np.random.default_rng(seed)
    ev = [(WINDOW, False, 1000, 9000)]

    def nest(a: int, b: int, depth: int) -> None:
        at = a
        while depth < 4 and at < b - 4 and rng.random() < 0.8:
            x = int(rng.integers(at, b - 3))
            y = int(rng.integers(x + 1, min(b, x + (b - a) // 2 + 2)))
            ev.append((f"kmh.{int(rng.integers(0, 3))}", False, x, y))
            nest(x, y, depth + 1)
            at = y

    for a, b in ((500, 5000), (6000, 9500)):  # across each edge
        ev.append(("kmh.top", False, a, b))
        nest(a, b, 1)
    for _ in range(60):
        x = int(rng.integers(0, 10000))
        ev.append((str(rng.choice(["cudaLaunchKernel", "aten::mul"])), False,
                   x, x + int(rng.integers(1, 40))))
        y = int(rng.integers(0, 10000))
        ev.append((str(rng.choice(["kern", "Memcpy DtoH", "Memset"])), True,
                   y, y + int(rng.integers(1, 300))))
    return Trace(events=ev)


@pytest.mark.parametrize("seed", range(6))
def test_idle_seconds_of_every_span_and_outside_sum_to_the_idle_share(seed):
    tr = random_trace(seed)
    t = spans.span_table(tr)
    assert t is not None and spans.OUTSIDE in t
    ns = {n: as_ns(r) for n, r in t.items()}
    window, busy = tr.t1 - tr.t0, round(tr.busy_s * 1e9)
    assert sum(r["self_s"] for r in ns.values()) == window
    assert sum(r["idle_s"] for r in ns.values()) == window - busy
    share = idle_share({"trace": tr})
    assert 100.0 * sum(r["idle_s"] for r in t.values()) / tr.window_s \
        == pytest.approx(share, abs=1e-9)
    for r in ns.values():
        assert 0 <= r["idle_s"] <= r["self_s"] <= r["host_s"] <= window
        assert r["kernel_s"] <= r["host_s"]


# -- the file entry's flagged reads ------------------------------------------

@pytest.mark.parametrize("exact_ll", ["hybrid", True])
def test_file_entry_records_flagged_reads(exact_ll, tmp_path):
    """``store.timings["flagged_reads"]`` after ``count_kmers_fq_sh_rp``:
    the reads the hybrid filter flagged and re-counted, as
    ``count_batches(stats=)`` gives them for the same reads; 0 in the
    exact filter, which flags none."""
    batches = [read_batch(s, 50) for s in range(3)]
    path = write_fastq(tmp_path / "f.fq", batches)
    st = api.count_kmers_fq_sh_rp(path, K, min_q=MIN_Q, exact_ll=exact_ll,
                                  batch_rows=64, device=CPU)
    stats: dict = {}
    counting.count_batches(api.CountStore(K, device=CPU), batches, K,
                           min_q=MIN_Q, exact_ll=exact_ll, stats=stats)
    assert st.timings["flagged_reads"] == stats["flagged_reads"]
    assert (st.timings["flagged_reads"] > 0) == (exact_ll == "hybrid")
    assert st.timings["file_reads"] == 150
