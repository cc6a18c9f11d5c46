"""The port's static model auditor held to the reference's (the twin of
``tests/test_analysis.py``).

The auditor is NumPy: the port's copy traces the port's closed forms, the
reference's traces its own, and every field of every audit must agree
(units, symbols, waivers, interval bounds, Sec. IV value pins, dead
hardware, unused graph symbols).  The provenance table must equal the
reference's and ``DESIGN.md``'s committed appendix, the mutation battery
must catch the same mutants, and the linter must give the same violations
on every file of both packages' ``core``.  The conformance preflight must
refuse a mis-transcribed model before anything is allocated.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import audit_composition_forms as j_audit_composition
from repro.analysis import audit_spec as j_audit_spec
from repro.analysis import lint_source as j_lint_source
from repro.analysis import render_provenance as j_render_provenance
from repro.analysis import run_mutation_battery as j_run_mutation_battery
from repro.core import registry as jregistry
from repro_torch.analysis import (BITS, DIMENSIONLESS, FLOAT64_EXACT_MAX,
                                  SpecAudit, TraceAbort, TraceContext, Unit,
                                  analysis_cache_info,
                                  audit_composition_forms, audit_registry,
                                  audit_spec, clear_analysis_cache,
                                  default_lint_roots, lint_paths,
                                  lint_source, mutate_spec,
                                  render_provenance, run_mutation_battery,
                                  trace_form, traced_record, unit_from_tag)
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis.__main__ import (PROVENANCE_BEGIN, PROVENANCE_END,
                                           extract_committed_provenance)
from repro_torch.core import conformance, registry
from repro_torch.core.dataflow import MOVEMENT_ROLES
from repro_torch.core.notation import (FieldUnit, declare_units,
                                       paper_default_graph,
                                       unit_declarations_for)
from repro_torch.core.terms import _VALID_HIERARCHIES
from repro_torch.core.validation import (SEC4_GOLDEN_TOTALS,
                                         crosscheck_registry)
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parents[1]
DATAFLOWS = ("engn", "hygcn", "spmm_tiled", "spmm_unfused", "awb_gcn")
KERNEL_SPECS = ("spmm_tiled_cta", "spmm_unfused_cta")
#: Every file of both packages' lint roots: ``core`` and ``distributed``.
CORE_FILES = sorted(
    str(p.relative_to(REPO))
    for pkg in ("repro", "repro_torch")
    for root in (REPO / "src" / pkg / "core",
                 REPO / "src" / pkg / "distributed")
    for p in root.glob("*.py"))


def _movement_fields(m) -> dict:
    """Every field of a MovementAudit, in comparable form."""
    return {
        "movement": m.movement, "role": m.role, "hierarchy": m.hierarchy,
        "bits_unit": m.bits_unit, "iters_unit": m.iters_unit,
        "symbols": m.symbols,
        "unit_issues": [str(i) for i in m.unit_issues],
        "waived": m.waived, "audit_note": m.audit_note,
        "overflows": [str(o) for o in m.overflows],
        "minimum_calls": m.minimum_calls, "trace_error": m.trace_error,
        "bits_bound": m.bits_bound, "iters_bound": m.iters_bound,
        "value_bits": m.value_bits, "value_iters": m.value_iters,
    }


def _assert_same_audit(port, ref) -> None:
    assert port.name == ref.name
    assert [_movement_fields(m) for m in port.movements] == [
        _movement_fields(m) for m in ref.movements]
    for f in ("dead_hw", "waived_dead_hw", "unused_graph",
              "golden_expected", "golden_actual", "envelope"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.strict_errors() == ref.strict_errors()
    assert port.as_dict() == ref.as_dict()


# ---------------------------------------------------------------------------
# audit parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DATAFLOWS)
def test_audit_spec_equals_reference(name):
    port = audit_spec(registry.get(name), use_cache=False)
    ref = j_audit_spec(jregistry.get(name), use_cache=False)
    _assert_same_audit(port, ref)
    assert port.ok and port.golden_ok


@pytest.mark.parametrize("envelope", [None, {"N": (1.0, 4096.0),
                                             "T": (1.0, 4096.0)},
                                      {"P": (0.0, 1e12)}])
def test_audit_envelopes_equal_reference(envelope):
    for name in DATAFLOWS:
        _assert_same_audit(
            audit_spec(registry.get(name), envelope=envelope,
                       use_cache=False),
            j_audit_spec(jregistry.get(name), envelope=envelope,
                         use_cache=False))


def test_composition_audit_equals_reference():
    port = audit_composition_forms(use_cache=False)
    _assert_same_audit(port, j_audit_composition(use_cache=False))
    assert port.name == "composition" and port.ok
    by_name = {m.movement: m for m in port.movements}
    assert set(by_name) == {"relationalhalo", "relationalhandoff",
                            "minibatchgather"}
    for name in ("relationalhalo", "relationalhandoff"):
        assert "graph.R" in by_name[name].symbols
        assert by_name[name].bits_unit == "bits"


@pytest.mark.parametrize("name", KERNEL_SPECS)
def test_kernel_specs_audit_strict_clean(name):
    a = audit_spec(registry.get(name), use_cache=False)
    assert a.strict_errors() == ()
    assert a.golden_expected is None
    assert a.unused_graph == ("L", "P")
    # A finding, not a strict error: at the envelope's corner (K = 10^7,
    # N = 1024) the per-feature-chunk adjacency re-reads of the H100
    # schedule reach 1.28e16 bits, past 2^53; the reference's TPU form
    # (one read per block) stays under it.
    (over,) = [o for m in a.movements for o in m.overflows]
    assert over.movement == f"{name}.loadadjblocks"
    assert 1.28e16 < over.bound < 1.29e16


def test_hygcn_waivers_and_engn_dead_hw_as_recorded():
    audits = audit_registry()
    hy = audits["hygcn"]
    waived = {m.movement: len(m.unit_issues) for m in hy.movements
              if m.waived}
    assert waived == {"aggregate": 2, "readinterphase": 2}
    assert hy.unit_error_count == 0 and hy.waived_issue_count == 4
    for m in hy.movements:
        if m.waived:
            assert "Table IV" in m.audit_note
    assert audits["engn"].waived_dead_hw == ("M_prime",)
    assert audits["engn"].dead_hw == ()
    assert set(audits) == set(registry.names())


def test_provenance_equals_reference_and_design_appendix():
    audits = audit_registry()
    audits["composition"] = audit_composition_forms()
    ref = {n: j_audit_spec(jregistry.get(n)) for n in jregistry.names()}
    ref["composition"] = j_audit_composition()
    table = render_provenance(audits)
    assert table == j_render_provenance(ref)
    committed = extract_committed_provenance(
        (REPO / "DESIGN.md").read_text())
    assert committed == table
    assert "waived (2)" in table and "ERROR" not in table


def test_value_pins_match_golden_totals():
    audits = audit_registry()
    for name, (total_bits, _) in SEC4_GOLDEN_TOTALS.items():
        a = audits[name]
        assert sum(m.value_bits for m in a.movements) == total_bits
        assert a.golden_actual == total_bits
        assert a.overflow_count == 0
        for m in a.movements:
            assert m.bits_bound <= FLOAT64_EXACT_MAX


# ---------------------------------------------------------------------------
# unit algebra and tracer semantics (twins of the reference's)
# ---------------------------------------------------------------------------

def test_unit_algebra():
    assert BITS * DIMENSIONLESS == BITS
    assert BITS / BITS == DIMENSIONLESS
    assert (BITS * BITS).bits_exp == 2
    assert str(BITS) == "bits"
    assert str(DIMENSIONLESS) == "dimensionless"
    assert str(Unit(2)) == "bits^2"
    assert unit_from_tag("bits") == BITS
    assert unit_from_tag("bits/iter") == BITS
    for tag in ("elements", "vertices", "edges", "PEs", "relations",
                "dimensionless"):
        assert unit_from_tag(tag) == DIMENSIONLESS
    with pytest.raises(ValueError):
        unit_from_tag("furlongs")


def test_unit_declarations_cover_all_records():
    g = paper_default_graph()
    assert set(unit_declarations_for(g)) == {
        f.name for f in dataclasses.fields(g)}
    for name in DATAFLOWS + KERNEL_SPECS:
        hw = registry.get(name).hw_factory()
        decls = unit_declarations_for(hw)
        assert set(decls) == {f.name for f in dataclasses.fields(hw)}, name
        ref_hw = (jregistry.get(name) if name in DATAFLOWS
                  else jregistry.get(name[:-4])).hw_factory()
        from repro.core.notation import unit_declarations_for as j_decls
        assert {k: dataclasses.astuple(v) for k, v in decls.items()} == {
            k: dataclasses.astuple(v) for k, v in j_decls(ref_hw).items()}


def test_declare_units_rejects_field_mismatch():
    @dataclasses.dataclass(frozen=True)
    class Rec:
        a: float = 1.0
        b: float = 2.0

    with pytest.raises(ValueError):
        declare_units(Rec, {"a": FieldUnit("bits")})
    with pytest.raises(ValueError):
        declare_units(Rec, {"a": FieldUnit("bits"), "b": FieldUnit("bits"),
                            "c": FieldUnit("bits")})
    declare_units(Rec, {"a": FieldUnit("bits"), "b": FieldUnit("elements")})
    with pytest.raises(ValueError, match="already registered"):
        declare_units(Rec, {"a": FieldUnit("bits"), "b": FieldUnit("bits")})
    with pytest.raises(KeyError, match="no unit declarations"):
        unit_declarations_for(object())


def _traced_pair():
    ctx = TraceContext(movement="t")
    g = traced_record(paper_default_graph(), "graph", ctx)
    hw = traced_record(registry.get("engn").hw_factory(), "hw", ctx)
    return ctx, g, hw


def test_tracer_unit_mismatch_taints_and_continues():
    ctx, g, hw = _traced_pair()
    bad = g.K + hw.sigma
    assert len(ctx.issues) == 1
    assert "mismatched units" in str(ctx.issues[0])
    assert bad.unit == DIMENSIONLESS
    more = bad * hw.sigma
    assert more.unit == BITS
    assert "graph.K" in more.symbols and "hw.sigma" in more.symbols


def test_tracer_ceil_requires_dimensionless():
    ctx, g, hw = _traced_pair()
    np.ceil(g.K * hw.sigma)
    assert any("ceil" in str(i) for i in ctx.issues)
    n0 = len(ctx.issues)
    np.ceil(g.K / g.L)
    assert len(ctx.issues) == n0


def test_tracer_branching_aborts():
    ctx, g, hw = _traced_pair()
    with pytest.raises(TraceAbort):
        bool(g.K > g.L)
    with pytest.raises(TraceAbort):
        float(g.K)


def test_tracer_where_and_comparison():
    ctx, g, hw = _traced_pair()
    cond = g.K > g.L
    assert cond.unit == DIMENSIONLESS and (cond.lo, cond.hi) == (0.0, 1.0)
    merged = np.where(cond, g.K, g.L)
    assert merged.unit == DIMENSIONLESS
    assert {"graph.K", "graph.L"} <= set(merged.symbols)
    assert merged.lo == 0.0 and merged.hi == 1e7


def test_tracer_interval_overflow_records():
    ctx, g, hw = _traced_pair()
    big = g.P * g.K
    assert big.hi > FLOAT64_EXACT_MAX
    assert len(ctx.overflows) == 1
    rec = ctx.overflows[0]
    assert rec.op == "multiply"
    assert {"graph.P", "graph.K"} <= set(rec.symbols)


@pytest.mark.parametrize("name", DATAFLOWS + KERNEL_SPECS)
def test_trace_form_on_every_movement(name):
    """Each port movement traces to bits / dimensionless with the same
    symbols as the reference form it copies (the kernel specs: their
    ``spmm_*`` parent's symbols or a superset)."""
    spec = registry.get(name)
    ref = jregistry.get(name.removesuffix("_cta"))
    ref_forms = {m.name: m.form for m in ref.movements}
    for m in spec.movements:
        ctx = TraceContext(movement=m.name)
        g = traced_record(paper_default_graph(), "graph", ctx)
        hw = traced_record(spec.hw_factory(), "hw", ctx)
        bits, iters = trace_form(m.form, g, hw, ctx, movement=m.name)
        jctx = TraceContext(movement=m.name)
        from repro.analysis import trace_form as j_trace_form
        from repro.analysis import traced_record as j_traced_record
        from repro.core.notation import paper_default_graph as j_graph
        jbits, jiters = j_trace_form(
            ref_forms[m.name], j_traced_record(j_graph(), "graph", jctx),
            j_traced_record(ref.hw_factory(), "hw", jctx), jctx,
            movement=m.name)
        if name in DATAFLOWS:
            assert (bits.symbols, iters.symbols) == (jbits.symbols,
                                                     jiters.symbols)
            assert (bits.lo, bits.hi, iters.hi) == (jbits.lo, jbits.hi,
                                                    jiters.hi)
        else:
            assert bits.symbols >= jbits.symbols
        assert str(bits.unit) == str(jbits.unit)
        assert str(iters.unit) == str(jiters.unit)


def test_widened_envelope_detects_overflow():
    wide = {"N": (1.0, 4096.0), "T": (1.0, 4096.0)}
    a = audit_spec(registry.get("engn"), envelope=wide)
    assert a.overflow_count > 0
    agg = next(m for m in a.movements if m.movement == "aggregate")
    assert agg.overflows and max(o.bound for o in agg.overflows) > 2**53
    assert a.strict_errors() == ()


def test_audit_spec_flags_undeclared_dead_hw():
    bare = dataclasses.replace(registry.get("engn"), unused_hw=())
    a = audit_spec(bare, use_cache=False)
    assert a.dead_hw == ("M_prime",)
    assert any("M_prime" in e for e in a.strict_errors())


def test_audit_cache_hits_and_misses():
    clear_analysis_cache()
    spec = registry.get("awb_gcn")
    a1 = audit_spec(spec)
    info = analysis_cache_info()
    assert info["misses"] >= 1 and info["entries"] >= 1
    a2 = audit_spec(spec)
    assert analysis_cache_info()["hits"] >= 1
    assert a1 is a2
    a3 = audit_spec(spec, envelope={"P": (0.0, 1e12)})
    assert a3 is not a1 and a3.envelope != a1.envelope


def test_reregistered_mutated_spec_is_reaudited_not_stale():
    base = registry.get("hygcn")
    baseline = audit_spec(base)
    assert baseline.ok
    mutant = next(m for m in mutate_spec(base) if m.name == "drop-sigma")
    swapped = dataclasses.replace(mutant.spec, name="hygcn")
    with registry.temporarily_registered(swapped, overwrite=True):
        assert registry.get("hygcn") is swapped
        audited = audit_spec(registry.get("hygcn"))
        assert audited is not baseline
        assert not audited.golden_ok
        assert audited.strict_errors() != ()
        with pytest.raises(AssertionError, match="model audit failure"):
            crosscheck_registry(analysis=True)
    assert audit_spec(registry.get("hygcn")) is baseline


def test_crosscheck_registry_analysis_records():
    records = crosscheck_registry(analysis=True)
    for name in registry.names():
        audit = records[f"{name}::analysis"]
        assert isinstance(audit, SpecAudit) and audit.ok
        assert records[name].ratio == 1.0


# ---------------------------------------------------------------------------
# the conformance preflight
# ---------------------------------------------------------------------------

def test_conformance_preflight_refuses_broken_model():
    base = registry.get("hygcn")
    mutant = next(m for m in mutate_spec(base) if m.name == "drop-sigma")
    swapped = dataclasses.replace(mutant.spec, name="hygcn")
    with registry.temporarily_registered(swapped, overwrite=True):
        with pytest.raises(AssertionError,
                           match="static model audit failure for 'hygcn'"):
            conformance.run_conformance(names=["hygcn"], points=(),
                                        device="cpu")
        with pytest.raises(ValueError, match="declares no runnable"):
            conformance.run_conformance(names=["hygcn"], points=(),
                                        device="cpu", preflight_audit=False)
    runnable = registry.runnable_names()[0]
    assert conformance.run_conformance(names=[runnable], points=(),
                                       device="cpu") == []


def test_preflight_refuses_a_mutant_kernel_spec_before_any_launch():
    """A drop-sigma ``spmm_tiled_cta`` shadowing the kernel spec: the gate
    names it, and nothing is allocated or launched."""
    mutant = next(m for m in mutate_spec(registry.get("spmm_tiled_cta"))
                  if m.name == "drop-sigma")
    swapped = dataclasses.replace(mutant.spec, name="spmm_tiled_cta")
    before = dict(ops.LAUNCHES)
    with registry.temporarily_registered(swapped, overwrite=True):
        with pytest.raises(AssertionError, match=(
                "static model audit failure for 'spmm_tiled_cta'")):
            conformance.run_conformance(device="cpu")
    assert dict(ops.LAUNCHES) == before
    assert "spmm_tiled_cta" not in registry.names()


def test_preflight_passes_the_real_specs_with_the_same_records():
    points = conformance.operating_points()
    gated = conformance.run_conformance(device="cpu")
    bypass = conformance.run_conformance(points=points, device="cpu",
                                         preflight_audit=False)
    # 204 schedule and boundary records, and one collective_wire record
    # per dataflow and point (2 x 12).
    assert len(gated) == 228 and all(r.ok for r in gated)
    assert [r.as_row() for r in gated] == [r.as_row() for r in bypass]
    fused = conformance.run_conformance(names=["spmm_tiled"],
                                        points=points[:2], device="cpu")
    assert {r.dataflow for r in fused} == {"spmm_tiled_cta"}
    assert not any(r.movement == "interphase_delta" for r in fused)


# ---------------------------------------------------------------------------
# mutation battery
# ---------------------------------------------------------------------------

def test_mutation_battery_equals_reference():
    port = run_mutation_battery()
    ref = j_run_mutation_battery()
    assert [o.as_dict() for o in port] == [o.as_dict() for o in ref]
    assert len(port) == 13 and all(o.caught for o in port)
    by_spec = {(o.spec, o.mutant) for o in port}
    for name in registry.names():
        assert (name, "drop-sigma") in by_spec
        assert (name, "swap-NT") in by_spec
    assert ("engn", "degenerate-minimum") in by_spec
    assert ("hygcn", "degenerate-minimum") in by_spec
    assert ("spmm_tiled", "degenerate-minimum") not in by_spec


@pytest.mark.parametrize("name", KERNEL_SPECS)
def test_mutation_battery_catches_kernel_spec_mutants(name):
    outcomes = run_mutation_battery(specs=[registry.get(name)])
    assert {o.mutant for o in outcomes} == {"drop-sigma", "swap-NT"}
    assert all(o.caught for o in outcomes)
    drop = next(o for o in outcomes if o.mutant == "drop-sigma")
    assert "unit-checker" in drop.caught_by


def test_drop_sigma_is_caught_by_unit_checker():
    outcomes = run_mutation_battery(specs=[registry.get("engn")])
    drop = next(o for o in outcomes if o.mutant == "drop-sigma")
    assert "unit-checker" in drop.caught_by
    assert "golden-totals" in drop.caught_by


# ---------------------------------------------------------------------------
# linter
# ---------------------------------------------------------------------------

def test_lint_vocabularies_match_runtime():
    assert set(lint_mod.VALID_HIERARCHIES) == set(_VALID_HIERARCHIES)
    assert tuple(lint_mod.VALID_ROLES) == tuple(MOVEMENT_ROLES)


@pytest.mark.parametrize("path", CORE_FILES)
def test_lint_source_equals_reference(path):
    source = (REPO / path).read_text()
    port = [v.as_dict() for v in lint_source(source, path)]
    assert port == [v.as_dict() for v in j_lint_source(source, path)]


def test_lint_builtin_min_and_transitive_helpers():
    src = ("def myform(g, hw):\n"
           "    return min(g.K, hw.B), g.K\n"
           "spec = MovementSpec('m', 'L2-L1', myform, role='edges')\n")
    assert [v.rule for v in lint_source(src, "core/x.py")] == [
        "form-builtin-min"]
    assert lint_source("def helper(a, b):\n    return min(a, b)\n") == []
    src = ("import math\n"
           "def _blocks(k):\n"
           "    return math.ceil(k / 256) * max(k, 1)\n"
           "def myform(g, hw):\n"
           "    return _blocks(g.K), g.K\n"
           "spec = MovementSpec('m', 'L2-L1', myform, role='edges')\n")
    assert sorted(v.rule for v in lint_source(src, "core/x.py")) == [
        "form-builtin-max", "form-math-ceil"]


def test_lint_lexsort_pragma_and_vocab_rules():
    src = "def f(a, b):\n    return np.lexsort((a, b))\n"
    path = "src/repro_torch/core/trace.py"
    assert [v.rule for v in lint_source(src, path)] == ["trace-lexsort"]
    assert lint_source(src, "src/repro_torch/core/sweep.py") == []
    ok = src.replace("\n    return np.lexsort((a, b))\n",
                     "\n    return np.lexsort((a, b))"
                     "  # lint: allow-trace-lexsort\n")
    assert lint_source(ok, path) == []
    for bad in ("spec = MovementSpec('m', 'L3-L1', f, role='edges')\n",
                "spec = MovementSpec('m', 'L2-L1', f, role='topology')\n",
                "spec = MovementSpec('m', HIER, f, role='edges')\n"):
        assert [v.rule for v in lint_source(bad)] == ["movement-vocab"]


def test_port_tree_lints_clean():
    pkg = REPO / "src" / "repro_torch"
    assert default_lint_roots() == (pkg / "core", pkg / "distributed")
    assert lint_paths() == []


def test_trace_pragmas_sit_only_on_lexsort_lines():
    """Every ``allow-trace-lexsort`` pragma of the port's trace module
    suppresses a real violation: with the pragmas stripped, the linter
    reports exactly one violation per pragma."""
    src = (REPO / "src" / "repro_torch" / "core" / "trace.py").read_text()
    bare = src.replace("  # lint: allow-trace-lexsort", "")
    rules = [v.rule for v in lint_source(bare, "src/repro_torch/core/"
                                                "trace.py")]
    assert rules == ["trace-lexsort"] * src.count("allow-trace-lexsort")


# ---------------------------------------------------------------------------
# CLI and the provenance drift gate
# ---------------------------------------------------------------------------

def _cli(*args, pythonpath=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pythonpath or REPO / "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=env)


def test_cli_strict_passes_and_writes_json(tmp_path):
    out = tmp_path / "analysis.json"
    r = _cli("--strict", "--json", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(out.read_text())
    assert payload["schema"] == "repro_torch.analysis/v1"
    assert payload["ok"] is True
    assert set(payload["dataflows"]) == set(registry.names()) | {
        "composition"}
    assert payload["lint"]["violations"] == []
    mb = payload["mutation_battery"]
    assert mb["ran"] and mb["caught"] == mb["total"] == 13
    hygcn = payload["dataflows"]["hygcn"]
    assert hygcn["waived_unit_issues"] == 4 and hygcn["unit_errors"] == 0
    assert "13/13 mutants caught" in r.stdout


def test_cli_usage_errors_exit_2():
    assert _cli("--check").returncode == 2
    assert _cli("--write").returncode == 2
    assert _cli("--provenance", "--check", "--write").returncode == 2


def test_cli_provenance_check_current_and_tampered(tmp_path):
    r = _cli("--provenance", "--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "current (38 movements)" in r.stdout
    scratch = tmp_path / "DESIGN.md"
    shutil.copy(REPO / "DESIGN.md", scratch)
    scratch.write_text(scratch.read_text().replace(
        "| engn | loadedges |", "| engn | loadedgez |"))
    r = _cli("--provenance", "--check", "--design", str(scratch))
    assert r.returncode == 1
    assert "STALE" in r.stderr
    r = _cli("--provenance", "--write", "--design", str(scratch))
    assert r.returncode == 0
    r = _cli("--provenance", "--check", "--design", str(scratch))
    assert r.returncode == 0
    assert scratch.read_text() == (REPO / "DESIGN.md").read_text()
    missing = tmp_path / "EMPTY.md"
    missing.write_text("no markers\n")
    assert _cli("--provenance", "--check", "--design",
                str(missing)).returncode == 1


def test_cli_strict_fails_on_escaped_model_error(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(
        "import numpy as np\n"
        "from repro_torch.core import registry\n"
        "from repro_torch.core.dataflow import DataflowSpec, MovementSpec\n"
        "from repro_torch.core.notation import EnGNHardwareParams\n"
        "def bad(g, hw):\n"
        "    bits = np.asarray(g.K * g.N, dtype=np.float64)\n"
        "    return bits, np.ones_like(bits)\n"
        "registry.register(DataflowSpec(\n"
        "    name='zz_bad', movements=(\n"
        "        MovementSpec('only', 'L2-L1', bad, role='other'),),\n"
        "    hw_factory=EnGNHardwareParams))\n")
    r = _cli("--strict", "--no-mutations",
             pythonpath=f"{tmp_path}:{REPO / 'src'}")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "zz_bad" in r.stdout + r.stderr


def test_provenance_markers_present_once():
    text = (REPO / "DESIGN.md").read_text()
    assert text.count(PROVENANCE_BEGIN) == 1
    assert text.count(PROVENANCE_END) == 1
