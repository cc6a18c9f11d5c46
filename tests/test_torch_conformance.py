"""The port's conformance harness against the JAX reference's geometry and
closed forms, on the CPU.

* Geometry: each CTA of the port's kernels touches exactly the logical
  blocks that the reference's Pallas grid specs give for its destination
  block (the port cuts them into feature chunks).
* Closed forms: every movement level that ``spmm_tiled_cta`` /
  ``spmm_unfused_cta`` share with the reference ``spmm_tiled`` /
  ``spmm_unfused`` is bit-identical in float64; the three levels the GPU
  schedule changes differ by exactly the stated factors.
* Harness: at all twelve operating points the per-CTA schedule equals the
  port spec, the launch boundary equals the tensors' bytes, and the
  unfused-minus-fused delta equals the reference's inter-phase terms.
"""

import math

import numpy as np
import pytest

from repro.core import registry as ref_registry
from repro.core.notation import GraphTileParams as RefGraph
from repro.core.notation import TiledSpMMHardwareParams as RefHW
from repro.kernels import edge_aggregate as jea
from repro.kernels import edge_aggregate_unfused as jeu
from repro_torch.core import conformance as conf
from repro_torch.core import registry
from repro_torch.core.notation import GraphTileParams, TiledSpMMHardwareParams
from repro_torch.kernels import edge_aggregate as ea
from repro_torch.kernels import edge_aggregate_unfused as eu

POINTS = conf.operating_points()
PT_IDS = [f"K{p.K}N{p.N}T{p.T}Bn{p.Bn}Bk{p.Bk}" for p in POINTS]
#: The reference's kernel-test shapes plus every operating point.
GEOMETRIES = ([(256, 32, 8, 128, 128), (512, 64, 16, 128, 256),
               (512, 128, 32, 256, 256), (1024, 16, 7, 256, 512)]
              + [(p.K, p.N, p.T, p.Bn, p.Bk) for p in POINTS])
GEO_IDS = [f"n{n}f{f}t{t}bn{bn}bk{bk}" for n, f, t, bn, bk in GEOMETRIES]


def _extent(geom, *idx):
    """Element extents of a reference BlockSpec block at grid index idx."""
    shape, index_map = geom
    bi = index_map(*idx)
    return tuple((int(b) * s, (int(b) + 1) * s) for b, s in zip(bi, shape))


def _by_operand(moves):
    out = {}
    for op, rows, cols in moves:
        out.setdefault(op, []).append((rows, cols))
    return out


def _block_moves(sched, i):
    """Every move of destination block ``i``: its ranks' moves, in rank
    order (the first grid axis runs over a block's ranks)."""
    ranks = sched.grid[0]
    return [m for r in range(ranks) for m in sched.moves(i * ranks + r)]


def _merge_cols(blocks):
    """{rows: merged (c0, c1)} of blocks that tile their columns in order."""
    merged = {}
    for rows, (c0, c1) in blocks:
        if rows in merged:
            assert merged[rows][1] == c0, "feature chunks must tile in order"
            merged[rows] = (merged[rows][0], c1)
        else:
            merged[rows] = (c0, c1)
    return merged


def _merge_rows(blocks):
    """{cols: merged (r0, r1)} of blocks that tile their rows in order."""
    return _merge_cols([(cols, rows) for rows, cols in blocks])


# ---------------------------------------------------------------------------
# Geometry against the reference grid specs, on every logical block.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,f,t,bn,bk", GEOMETRIES, ids=GEO_IDS)
def test_fused_geometry_covers_the_reference_blocks(n, f, t, bn, bk):
    grid, (a_g, x_g, w_g), out_g = jea.fused_grid_spec(n, f, t, bn, bk)
    sched = ea.fused_grid_spec(n, f, t, bn, bk)
    nfc = math.ceil(f / sched.chunk)
    assert sched.grid[1:] == (grid[0],)
    for i in range(grid[0]):
        moves = _by_operand(_block_moves(sched, i))
        ref_a = [_extent(a_g, i, j) for j in range(grid[1])]
        assert sorted(moves["a"]) == sorted(ref_a * nfc)
        assert _merge_cols(moves["x"]) == {
            _extent(x_g, i, j)[0]: _extent(x_g, i, j)[1]
            for j in range(grid[1])}
        assert _merge_rows(moves["w"]) == {(0, t): _extent(w_g, i, 0)[0]}
        assert moves["out"] == [_extent(out_g, i, grid[1] - 1)]


@pytest.mark.parametrize("n,f,t,bn,bk", GEOMETRIES, ids=GEO_IDS)
def test_unfused_geometry_covers_the_reference_blocks(n, f, t, bn, bk):
    grid, (a_g, x_g), y_g = jeu.aggregate_grid_spec(n, f, bn, bk)
    sched = eu.aggregate_grid_spec(n, f, bn, bk)
    nfc = math.ceil(f / sched.chunk)
    assert sched.grid[1:] == (grid[0],) and sched.chunk == ea.feature_chunk(bn)
    for i in range(grid[0]):
        moves = _by_operand(_block_moves(sched, i))
        ref_a = [_extent(a_g, i, j) for j in range(grid[1])]
        assert sorted(moves["a"]) == sorted(ref_a * nfc)
        assert _merge_cols(moves["x"]) == {
            _extent(x_g, i, j)[0]: _extent(x_g, i, j)[1]
            for j in range(grid[1])}
        assert _merge_cols(moves["y"]) == {
            _extent(y_g, i, 0)[0]: _extent(y_g, i, 0)[1]}

    grid, (y_g, w_g), out_g = jeu.combine_grid_spec(n, f, t, bn)
    sched = eu.combine_grid_spec(n, f, t, bn)
    assert sched.grid[1:] == grid
    for i in range(grid[0]):
        # The union of a block's rank moves: its aggregate rows, all of W
        # and its output tile, each once.
        moves = _by_operand(_block_moves(sched, i))
        assert _merge_cols(sorted(moves["y"], key=lambda m: m[1])) == {
            _extent(y_g, i)[0]: _extent(y_g, i)[1]}
        assert _merge_rows(sorted(moves["w"])) == {(0, t): _extent(w_g, i)[0]}
        assert moves["out"] == [_extent(out_g, i)]


# ---------------------------------------------------------------------------
# The cluster schedules against one CTA per destination block.
# ---------------------------------------------------------------------------
def _row_block_schedule(n, f, t, bn, bk, kernel):
    """One CTA per destination block walking every chunk (and, for K1 and
    K2, every source block), written out here: the schedule the clusters
    must match byte for byte."""
    fc = ea.feature_chunk(bn)
    chunks = [(c, min(f, c + fc)) for c in range(0, f, fc)]

    def moves(i):
        rows = (i * bn, (i + 1) * bn)
        for cols in chunks:
            if kernel == "K3":
                yield "y", rows, cols
                yield "w", cols, (0, t)
                continue
            for j in range(0, n, bk):
                yield "a", rows, (j, j + bk)
                yield "x", (j, j + bk), cols
            yield ("w", cols, (0, t)) if kernel == "K1" else ("y", rows, cols)
        if kernel != "K2":
            yield "out", rows, (0, t)

    operands = {"K1": {"a": (n, n), "x": (n, f), "w": (f, t), "out": (n, t)},
                "K2": {"a": (n, n), "x": (n, f), "y": (n, f)},
                "K3": {"y": (n, f), "w": (f, t), "out": (n, t)}}[kernel]
    return ea.CtaSchedule(grid=(n // bn,), block_n=bn, block_k=bk, chunk=fc,
                          smem_bytes=0, operands=operands, moves=moves)


def _kernel_schedule(kernel, n, f, t, bn, bk):
    return {"K1": lambda: ea.fused_grid_spec(n, f, t, bn, bk),
            "K2": lambda: eu.aggregate_grid_spec(n, f, bn, bk),
            "K3": lambda: eu.combine_grid_spec(n, f, t, bn)}[kernel]()


@pytest.mark.parametrize("pt", POINTS, ids=PT_IDS)
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_cluster_schedule_traces_the_row_block_bytes(pt, kernel):
    K, N, T, bn, bk = pt.K, pt.N, pt.T, pt.Bn, pt.Bk
    acct = {"K1": lambda: ea.fused_block_streams(K, N, T, block_n=bn,
                                                 block_k=bk),
            "K2": lambda: eu.aggregate_block_streams(K, N, block_n=bn,
                                                     block_k=bk),
            "K3": lambda: eu.combine_block_streams(K, N, T, block_n=bn)
            }[kernel]()
    got = conf.block_schedule(acct["schedule"], acct["streams"])
    expect = conf.block_schedule(_row_block_schedule(K, N, T, bn, bk, kernel),
                                 acct["streams"])
    assert got == expect


@pytest.mark.parametrize("n,f,t,bn,bk", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_cluster_schedule_covers_each_block_once(n, f, t, bn, bk, kernel):
    sched = _kernel_schedule(kernel, n, f, t, bn, bk)
    ranks, nrb = sched.grid
    assert nrb == n // bn and 1 <= sched.cluster <= ea.MAX_CLUSTER
    assert ranks % sched.cluster == 0
    assert sched.cluster in ((ranks,) if kernel != "K2" or ranks == 1
                             else (1, ranks))
    chunks = ea.chunk_bounds(f, sched.chunk)
    for i in range(nrb):
        moves = _by_operand(_block_moves(sched, i))
        rows = (i * bn, (i + 1) * bn)
        if kernel == "K3":
            assert sorted(moves["y"]) == [(rows, c) for c in chunks]
            assert sorted(moves["w"]) == [(c, (0, t)) for c in chunks]
            assert moves["out"] == [(rows, (0, t))]
            continue
        pairs = sorted(zip(moves["a"], moves["x"]))
        expect = sorted(((rows, (j, j + bk)), ((j, j + bk), cols))
                        for cols in chunks for j in range(0, n, bk))
        assert pairs == expect      # each (chunk, source block) exactly once
        if kernel == "K1":
            assert sorted(moves["w"]) == [(c, (0, t)) for c in chunks]
            assert moves["out"] == [(rows, (0, t))]
        else:
            assert sorted(moves["y"]) == [(rows, c) for c in chunks]


@pytest.mark.parametrize("pt", POINTS, ids=PT_IDS)
def test_combine_ranks_follow_the_documented_plan(pt):
    """K3: one rank per feature chunk up to a cluster of 8; rank r reads the
    aggregate rows and W rows of chunks r, r + ranks, ...; the leader
    writes the tile; one chunk is one CTA and no cluster."""
    sched = eu.combine_grid_spec(pt.K, pt.N, pt.T, pt.Bn)
    chunks = ea.chunk_bounds(pt.N, ea.feature_chunk(pt.Bn))
    ranks = min(len(chunks), ea.MAX_CLUSTER)
    assert eu.combine_plan(pt.N, pt.Bn) == (ranks, ranks if ranks > 1 else 1)
    assert sched.grid == (ranks, pt.K // pt.Bn)
    assert sched.cluster == (ranks if ranks > 1 else 1)
    assert sched.smem_bytes == eu.combine_smem_bytes(pt.Bn, pt.T)
    for b in range(pt.K // pt.Bn):
        rows = (b * pt.Bn, (b + 1) * pt.Bn)
        for r in range(ranks):
            expect = [m for c in chunks[r::ranks]
                      for m in (("y", rows, c), ("w", c, (0, pt.T)))]
            if r == 0:
                expect.append(("out", rows, (0, pt.T)))
            assert list(sched.moves(b * ranks + r)) == expect


@pytest.mark.parametrize("n,bn,bk,ranks,sizes", [
    (2816, 64, 256, 2, [6, 5]),          # Cora layer 2: 88 CTAs
    (1024, 512, 256, 4, [1, 1, 1, 1]),
    (2048, 64, 128, 4, [4, 4, 4, 4]),    # 32 blocks x 4 = 128 CTAs
    (512, 512, 16, 8, [4] * 8),          # units of 4 blocks (64 sources)
    (2816, 16, 256, 1, [11]),            # 176 blocks fill the SMs alone
    (3072, 32, 256, 1, [12]),            # 96 blocks: 2 ranks would not fit
])
def test_one_chunk_ranks_split_whole_source_blocks(n, bn, bk, ranks, sizes):
    assert ea.cta_plan(n, 16, bn, bk, True) == (ranks, True, ranks)
    assert ea.cta_plan(n, 16, bn, bk, False) == (ranks, True, ranks)
    spans = [ea.source_range(n, bk, ranks, r) for r in range(ranks)]
    assert [(hi - lo) // bk for lo, hi in spans] == sizes
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(lo % ea.SPLIT_SOURCES == 0 for lo, _ in spans)


def test_cora_layer_grids_fill_the_sms():
    """Layer 1: 6 chunks x 88 blocks = 528 CTAs (4 x 132); layer 2: 11
    source blocks as 6/5 over 44 blocks = 88 CTAs, one wave."""
    l1, l2 = conf.cora_operating_points()
    s1 = ea.fused_grid_spec(l1.K, l1.N, l1.T, l1.Bn, l1.Bk)
    s2 = ea.fused_grid_spec(l2.K, l2.N, l2.T, l2.Bn, l2.Bk)
    assert (s1.grid, s1.cluster) == ((6, 88), 6)
    assert (s2.grid, s2.cluster) == ((2, 44), 2)
    u1 = eu.aggregate_grid_spec(l1.K, l1.N, l1.Bn, l1.Bk)
    assert (u1.grid, u1.cluster) == ((6, 88), 1)
    assert math.prod(s1.grid) == 4 * ea.SMS and math.prod(s2.grid) <= ea.SMS
    # K3: layer 1's 6 chunks over clusters of 6 (528 CTAs); layer 2's one
    # chunk one CTA a block (44 CTAs).
    c1 = eu.combine_grid_spec(l1.K, l1.N, l1.T, l1.Bn)
    c2 = eu.combine_grid_spec(l2.K, l2.N, l2.T, l2.Bn)
    assert (c1.grid, c1.cluster) == ((6, 88), 6)
    assert (c2.grid, c2.cluster) == ((1, 44), 1)
    assert math.prod(c1.grid) == 4 * ea.SMS


@pytest.mark.parametrize("block_n,fc", [(16, 512), (32, 256), (128, 64),
                                        (256, 32), (512, 16), (64, 128)])
def test_feature_chunk_fills_the_cta_accumulator(block_n, fc):
    assert ea.feature_chunk(block_n) == fc == ea.ACC_ELEMS // block_n


@pytest.mark.parametrize("block_n", [8, 24, 96, 1024])
def test_feature_chunk_rejects_unsupported_blocks(block_n):
    with pytest.raises(ValueError, match="block_n"):
        ea.feature_chunk(block_n)


# ---------------------------------------------------------------------------
# Closed forms against the reference specs, float64.
# ---------------------------------------------------------------------------
def _pair(point):
    kw = dict(N=point.N, T=point.T, K=point.K, L=point.K // 10,
              P=10 * point.K)
    hw = dict(sigma=point.sigma_bits, sigma_adj=point.sigma_bits,
              Bn=point.Bn, Bk=point.Bk)
    return (GraphTileParams(**kw), TiledSpMMHardwareParams(**hw),
            RefGraph(**kw), RefHW(**hw))


@pytest.mark.parametrize("port,ref", [("spmm_tiled_cta", "spmm_tiled"),
                                      ("spmm_unfused_cta", "spmm_unfused")])
@pytest.mark.parametrize("pt", POINTS, ids=PT_IDS)
def test_closed_forms_match_reference(port, ref, pt):
    g, hw, rg, rhw = _pair(pt)
    out = registry.get(port).evaluate(g, hw)
    expect = ref_registry.get(ref).evaluate(rg, rhw)
    assert out.names() == expect.names()
    nbn, nbk = pt.K / pt.Bn, pt.K / pt.Bk
    nfc = math.ceil(pt.N / (ea.ACC_ELEMS / pt.Bn))
    factor = {"loadweights": nbn, "loadadjblocks": nfc,
              "loadvertblocks": nbn if nbk == 1 else 1.0}
    for name in out.names():
        got, want = out[name], expect[name]
        assert got.hierarchy == want.hierarchy
        f = factor.get(name, 1.0)
        # Shared levels bit-identical; changed levels by exact factors.
        assert float(got.data_bits) == float(want.data_bits) * f, name
        assert float(got.iterations) == float(want.iterations) * f, name
    changed = {n for n in out.names() if factor.get(n, 1.0) != 1.0}
    assert changed <= {"loadweights", "loadvertblocks", "loadadjblocks"}
    assert "loadweights" in changed or nbn == 1


def test_cora_points_chunk_the_features():
    """Layer 1 re-reads A in 6 chunks; layer 2 fits one chunk."""
    l1, l2 = conf.cora_operating_points()
    assert (l1.K, l1.N, l1.T) == (2816, 1433, 16)
    assert (l2.K, l2.N, l2.T) == (2816, 16, 7)
    assert all(2816 % b == 0 for p in (l1, l2) for b in (p.Bn, p.Bk))
    assert math.ceil(l1.N / ea.feature_chunk(l1.Bn)) == 6
    assert math.ceil(l2.N / ea.feature_chunk(l2.Bn)) == 1
    # A is 31.7 MB and layer-1 X 16.1 MB in f32.
    assert 4 * 2816 * 2816 == 31_719_424 and 4 * 2816 * 1433 == 16_141_312


# ---------------------------------------------------------------------------
# The harness at all twelve points.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pt", POINTS, ids=PT_IDS)
def test_schedule_and_boundary_conform(pt):
    for name in registry.runnable_names():
        records = conf.conformance_records(registry.get(name), pt,
                                           device="cpu")
        assert {r.source for r in records} == {"block_schedule",
                                               "launch_boundary"}
        for r in records:
            assert r.ok and r.tolerance == conf.EXACT_REL_TOL, str(r)
            assert r.analytical_bytes > 0, str(r)
        spec = registry.get(name)
        offchip = {m.name for m in spec.movements if m.hierarchy != "L1-L1"}
        traced = {r.movement for r in records
                  if r.source == "block_schedule" and r.movement != "hbm_total"}
        assert traced == offchip


@pytest.mark.parametrize("pt", POINTS, ids=PT_IDS)
def test_launch_boundary_is_the_tensor_bytes(pt):
    K, N, T, e = pt.K, pt.N, pt.T, pt.elem_bytes
    fused = conf.FusedCtaAnalogue().programs(pt, "cpu")
    unfused = conf.UnfusedCtaAnalogue().programs(pt, "cpu")
    assert conf.launch_boundary(fused[0].tensors) == e * (K * K + K * N
                                                          + N * T + K * T)
    assert [conf.launch_boundary(p.tensors) for p in unfused] == [
        e * (K * K + 2 * K * N), e * (K * N + N * T + K * T)]


@pytest.mark.parametrize("pt", POINTS, ids=PT_IDS)
def test_interphase_delta_is_the_reference_terms(pt):
    _, _, rg, rhw = _pair(pt)
    ref = ref_registry.get("spmm_unfused").evaluate(rg, rhw)
    expect = (float(ref["writeinterphase"].data_bits)
              + float(ref["readinterphase"].data_bits)) / 8.0
    assert expect == 2 * pt.K * pt.N * pt.elem_bytes
    recs = conf.interphase_delta(pt, device="cpu")
    assert {r.source for r in recs} == {"launch_boundary", "block_schedule"}
    for r in recs:
        assert r.analytical_bytes == expect
        assert r.measured_bytes == expect and r.ok


def test_block_schedule_counts_every_cta_load():
    """No revisit elision: W is loaded by every CTA, X by every CTA at
    nbk == 1 (the TPU loads each once)."""
    acct = ea.fused_block_streams(512, 16, 8, block_n=128, block_k=512)
    traced = conf.block_schedule(acct["schedule"], acct["streams"])
    assert traced["loadweights"]["transfers"] == 4
    assert traced["loadweights"]["bytes"] == 4 * 16 * 8 * 4.0
    assert traced["loadweights"]["distinct_bytes"] == 16 * 8 * 4.0
    assert traced["loadvertblocks"]["bytes"] == 4 * 512 * 16 * 4.0


def test_verify_numerics_and_cli_on_cpu(tmp_path, capsys):
    assert conf.verify_numerics(POINTS[0], device="cpu") < 1e-5
    path = tmp_path / "conf.json"
    rc = conf.main(["--device", "cpu", "--points", "3", "--execute",
                    "--json", str(path)])
    assert rc == 0
    assert "all conformance records within declared tolerance" in (
        capsys.readouterr().out)
    import json
    payload = json.loads(path.read_text())
    assert payload["conformance"]["all_ok"]
    assert payload["conformance"]["device"] == "cpu"


def test_port_registry_is_its_own_namespace():
    assert registry.names() == ["engn", "hygcn", "awb_gcn",
                                "spmm_tiled_cta", "spmm_unfused_cta"]
    assert registry.runnable_names() == ["spmm_tiled_cta", "spmm_unfused_cta"]
    with pytest.raises(KeyError, match="unknown port dataflow"):
        registry.get("spmm_tiled")
    # The closed forms the port shares with the reference are its own copies.
    shared = set(registry.names()) & set(ref_registry.names())
    assert shared == {"engn", "hygcn", "awb_gcn"}
    assert all(registry.get(n) is not ref_registry.get(n) for n in shared)


def test_operating_points_are_the_reference_ten_plus_cora():
    from repro.core.conformance import default_operating_points as ref_pts
    assert [p.as_dict() for p in conf.default_operating_points()] == [
        p.as_dict() for p in ref_pts()]
    assert len(POINTS) == 12
    with pytest.raises(ValueError, match="divide"):
        conf.OperatingPoint(K=300, N=16, T=8, Bn=128, Bk=128)
