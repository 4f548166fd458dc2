"""The port's ``ntxent-audit`` (``ntxent_tpu_torch/analysis/graph``)
against the JAX package's on the same inputs.

One gloo world of P = 2 (one spawn for the file, one CPU thread a rank;
rank code ``torch_dist_workers.run_audit``) runs every audit target
under the collective census, the wire-dtype and donation analyzers, a
doctored float32 payload under int8, a snapshot of ``.numpy()`` views,
and two sharded train steps with a timeline. In this process
``ntxent_tpu.analysis.graph.census.jaxpr_census`` traces the JAX targets
on a mesh of the same P. Every byte count is derived here from the ring
formulas (``RING_FACTORS``) and the targets' shapes:

* forward targets: the census equals the declared accounting, and the
  JAX census where JAX's equals its own declarations (``dist_loss``,
  the chunked ring); JAX's ``ring/fwd`` census misses the loss's psum and
  sends an int32 id block the port derives from the hop, so the port's
  ring is held to its declarations and the ring formulas;
* ``dist_loss/grad``: gloo has no reduce-scatter, so the all-gather's
  backward is an all-reduce of the full cotangent: 4 + 128 = 132 B of
  autograd traffic at P = 2, where NCCL's ``reduce_scatter_tensor``
  gives 4 + 64 = 68 B, JAX's remainder;
* the chunked ring's backward is JAX AD's transpose of the forward's
  hops: the psum's backward and (P - 1) hops of the block's cotangent,
  4 + (P - 1) B = 132 B, JAX's census.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_dist_workers as workers
from ntxent_tpu_torch.analysis.graph import census as tcensus
from ntxent_tpu_torch.analysis.graph import recompile as trecompile
from ntxent_tpu_torch.analysis.graph.targets import default_targets
from test_torch_distributed import _spawn

pytestmark = pytest.mark.graphaudit

REPO = Path(__file__).resolve().parents[1]
P = 2
PSUM = tcensus.RING_FACTORS["psum"]
SCATTER = tcensus.RING_FACTORS["psum_scatter"]
GATHER = tcensus.RING_FACTORS["all_gather"]
N_LOCAL, DIM, F32 = 2, 8, 4
# the (2 n, D) stacked block of the chunked ring and the ring: 128 B
BLOCK = 2 * N_LOCAL * DIM * F32
# one rank's z1 shard, all-gathered: 64 B a call
SHARD = N_LOCAL * DIM * F32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's results of the P = 2 audit world (rank 1's must agree)."""
    tmp = tmp_path_factory.mktemp("audit")
    _spawn(workers.run_audit, P, (str(tmp),), tmp)
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(P)]
    assert [r["findings"] for r in ranks] == [[], []]
    return ranks[0]


@pytest.fixture(scope="module")
def jax_census():
    """``{target: (census_totals by op, declared by op, ad_bytes)}`` of
    the JAX package's audit targets on a mesh of P CPU devices."""
    from ntxent_tpu.analysis.graph import census as jcensus
    from ntxent_tpu.analysis.graph.targets import audit_mesh
    from ntxent_tpu.analysis.graph.targets import (
        default_targets as jax_targets,
    )

    out = {}
    for t in jax_targets(audit_mesh(P)):
        if t.kind in ("donation", "census-gspmd"):
            continue
        built = t.build()
        entries, declared = jcensus.census_of_callable(built["fn"],
                                                       *built["args"])
        by_op = {}
        for (op, _), (c, b) in jcensus.census_totals(entries).items():
            slot = by_op.setdefault(op, [0, 0.0])
            slot[0] += c
            slot[1] += b
        out[t.name] = (by_op, declared,
                       jcensus.graph_remainder(entries, declared)["ad_bytes"])
    return out


def _wire(report, name):
    return {op: list(v) for op, v in report[name]["wire"].items()}


def test_the_audit_ranks_load_no_jax(world):
    assert world["jax_loaded"] is False


@pytest.mark.parametrize("name", ["dist_loss/fwd", "dist_loss_chunked/fwd",
                                  "ring/fwd", "tp/matmul"])
def test_forward_census_equals_the_declared_sites(world, name):
    summary = world["report"][name]
    assert summary["wire"] == summary["declared_wire"]
    assert summary["graph_bytes"] == summary["declared_bytes"] > 0
    assert summary["ad_bytes"] == 0.0


@pytest.mark.parametrize("name,want", [
    ("dist_loss/fwd", {"all_gather": [2, 2 * GATHER(SHARD, P)],
                       "psum": [1, PSUM(F32, P)]}),
    ("dist_loss_chunked/fwd", {"ppermute": [2, (P - 1) * BLOCK],
                               "psum": [1, PSUM(F32, P)]}),
])
def test_forward_census_matches_jax(world, jax_census, name, want):
    assert _wire(world["report"], name) == want
    assert jax_census[name][0] == want


def test_ring_census_holds_the_ring_formulas(world, jax_census):
    """P - 1 hops of the (2n, D) block and the loss's psum, as declared;
    JAX's census of its ring reads 2 hops of 144 B (the block and its
    int32 ids) and no psum (the reference's own failing golden test)."""
    assert _wire(world["report"], "ring/fwd") == {
        "ppermute": [P - 1, (P - 1) * BLOCK], "psum": [1, PSUM(F32, P)]}
    assert jax_census["ring/fwd"][0] == {
        "ppermute": [2, (P - 1) * (BLOCK + 2 * N_LOCAL * 4)]}


def test_tp_matmul_is_one_row_parallel_psum(world):
    """(4, 8) float32 partial outputs summed over the group, declared as
    ``tp_psum`` and seen as one all-reduce."""
    assert _wire(world["report"], "tp/matmul") == {
        "psum": [1, PSUM(4 * 8 * F32, P)]}


def test_dist_loss_grad_remainder_gloo_and_nccl_forms(world, jax_census):
    """The autograd remainder of the strip's gradient: the psum's
    backward (a scalar psum) and the all-gather's (the reduce-scatter of
    the (P n, D) cotangent, an all-reduce of it on gloo)."""
    cotangent = P * N_LOCAL * DIM * F32
    gloo = PSUM(F32, P) + PSUM(cotangent, P)
    nccl = PSUM(F32, P) + SCATTER(cotangent, P)
    assert (gloo, nccl) == (132.0, 68.0)
    assert world["report"]["dist_loss/grad"]["ad_bytes"] == gloo
    assert jax_census["dist_loss/grad"][2] == nccl


def test_chunked_and_ring_grad_remainders(world, jax_census):
    """The chunked ring's backward transposes the forward hops, as JAX's
    AD does: the psum's backward and (P - 1) B of cotangent hops, JAX's
    census exactly. The ring's jnp backward is the inverse hop and the
    psum's backward; JAX's census misses the psum there too."""
    report = world["report"]
    assert report["dist_loss_chunked/grad"]["ad_bytes"] == \
        PSUM(F32, P) + (P - 1) * BLOCK == 132.0
    assert jax_census["dist_loss_chunked/grad"][2] == \
        PSUM(F32, P) + (P - 1) * BLOCK
    assert report["ring/grad"]["ad_bytes"] == \
        PSUM(F32, P) + (P - 1) * BLOCK
    assert jax_census["ring/grad"][2] == (P - 1) * BLOCK


def test_grad_census_ran_on_the_calling_thread_on_the_cpu(world):
    """CPU autograd runs the backward on the caller's thread; on the card
    the census follows it to the device thread (``chip_smoke.py``
    ``[audit]``)."""
    for name in ("dist_loss/grad", "ring/grad", "dist_loss_chunked/grad"):
        assert world["report"][name]["autograd_thread_ops"] == []
        assert {e[5] for e in world["entries"][name]} == {"caller"}


def test_serving_rung_census_is_empty(world, jax_census):
    assert world["entries"]["serving/rung_int8"] == []
    assert jax_census["serving/rung_int8"][0] == {}


def _by_op(entries):
    out = {}
    for op, _dtype, _shape, calls, nbytes, _thread in entries:
        slot = out.setdefault(op, [0, 0.0])
        slot[0] += calls
        slot[1] += nbytes
    return out


def test_int8_grad_reduce_matches_jax_per_op(world, jax_census):
    """The two-phase schedule over {w: 4096, b: 4}: b's float32 psum,
    the all-to-all and all-gather of w's int8 chunks and their scales;
    JAX's census equals it op for op, and both totals equal the
    declared pmean (5 calls, 4120 B)."""
    got = _by_op(world["entries"]["grad_reduce/int8"])
    want = {"psum": [1, PSUM(4 * F32, P)],
            "all_to_all": [2, SCATTER(4096 + P * F32, P)],
            "all_gather": [2, GATHER(4096 // P + F32, P)]}
    assert got == want == jax_census["grad_reduce/int8"][0]
    assert jax_census["grad_reduce/int8"][1] == {("pmean", "data"):
                                                 (5, 4120.0)}
    assert sum(b for _, b in got.values()) == 4120.0


def test_bf16_grad_reduce_is_one_flat_psum(world, jax_census):
    """``pmean_`` concatenates the leaves: one bf16 all-reduce of 4100
    values, the bytes of JAX's two (one a leaf)."""
    assert _by_op(world["entries"]["grad_reduce/bf16"]) == {
        "psum": [1, PSUM(4100 * 2, P)]}
    assert jax_census["grad_reduce/bf16"][0] == {
        "psum": [2, PSUM(4100 * 2, P)]}


def test_chunked_int8_hops_match_jax(world, jax_census):
    want = {"ppermute": [4, 2 * (2 * 512 + 2 * F32)],
            "psum": [1, PSUM(F32, P)]}
    assert _by_op(world["entries"]["dist_loss_chunked/int8"]) == want
    assert jax_census["dist_loss_chunked/int8"][0] == want


def test_wire_dtype_targets_ride_compressed(world):
    for name, policy in (("grad_reduce/int8", "int8"),
                         ("dist_loss_chunked/int8", "int8"),
                         ("grad_reduce/bf16", "bfloat16")):
        big = {e[1] for e in world["entries"][name]
               if int(np.prod(e[2])) >= 1024}
        assert big == {policy}, name


def test_doctored_f32_payload_under_int8_gives_one_finding(world):
    (finding,) = world["doctored"]
    assert finding["rule"] == "wire-dtype"
    assert finding["snippet"] == "psum|P=2|float32|2048"


def test_donation_flags_numpy_views_and_passes_snapshot_state(world):
    """A snapshot of ``.numpy()`` views aliases every CPU tensor of the
    model and goes stale across the step; the audit suite's real
    ``snapshot_state`` target raised nothing (``world``'s findings)."""
    kinds = {f["snippet"].split("|")[0] for f in world["views"]}
    assert kinds == {"snapshot-view", "stale-after-step"}
    views = [f for f in world["views"]
             if f["snippet"].startswith("snapshot-view")]
    assert any("convs.0.weight" in f["snippet"] for f in views)


def test_timed_train_step_publishes_the_analytic_ad_bytes(world):
    """Two sharded steps of the tiny audit model (2 rows a rank, width-8
    projection) with a timeline: step 1's census publishes the backward
    of both views' all-gathers (an all-reduce of each (P n, 8) cotangent
    on gloo) and of the loss's psum."""
    cotangent = P * 2 * 8 * F32
    assert world["train_ad_bytes"] == 2 * PSUM(cotangent, P) + PSUM(F32, P)


# ---------------------------------------------------------------------------
# the census's own rules, in this process


def test_an_unmapped_c10d_op_is_an_error():
    with pytest.raises(tcensus.CensusError, match="gather_"):
        tcensus._entry("gather_", (), "caller")
    assert tcensus._entry("recv_", (), "caller") is None


def test_remainder_floors_per_wire_op():
    """An over-declared op cannot cancel an under-declared one; a
    declared pmean meets the census's psum."""
    entries = [tcensus.CensusEntry("psum", "P=2", (4,), "float32", 1, 16.0),
               tcensus.CensusEntry("all_gather", "P=2", (4,), "float32", 1,
                                   8.0)]
    declared = {("pmean", "data"): (1, 10.0),
                ("all_gather", "data"): (1, 20.0)}
    assert tcensus.graph_remainder(entries, declared) == {
        "graph_bytes": 24.0, "declared_bytes": 30.0, "ad_bytes": 6.0,
        "graph_calls": 2}


def test_census_totals_equal_jax_on_the_same_entries():
    from ntxent_tpu.analysis.graph import census as jcensus

    rows = [("psum", "data", (4,), "float32", 2, 16.0),
            ("all_gather", "data", (2, 3), "int8", 1, 6.0)]
    got = tcensus.census_totals([tcensus.CensusEntry(*r) for r in rows])
    assert got == jcensus.census_totals([jcensus.CensusEntry(*r)
                                         for r in rows])
    assert tcensus.RING_FACTORS.keys() == jcensus.RING_FACTORS.keys()
    for op, f in tcensus.RING_FACTORS.items():
        assert f(96.0, 4) == jcensus.RING_FACTORS[op](96.0, 4)


# ---------------------------------------------------------------------------
# recompile causes: one copy in the port, JAX's semantics

CHURN_STREAMS = [
    [{"event": "compile", "bucket": 4, "dtype": "float32",
      "cause": "first_compile"},
     {"event": "compile", "bucket": 8, "dtype": "float32"}],
    [{"event": "compile", "bucket": 4, "dtype": "int8", "structure": "a",
      "cause": "recompile"}] * 4,
    [{"event": "compile", "bucket": 4, "cause": "weights_reload"}] * 5
    + [{"event": "compile", "duration_ms": 3.0}],
]


@pytest.mark.parametrize("events", CHURN_STREAMS)
def test_churn_findings_equal_jax(events):
    from ntxent_tpu.analysis.graph import recompile as jrecompile

    got = [vars(f) for f in trecompile.churn_findings(events)]
    assert got == [vars(f) for f in jrecompile.churn_findings(events)]


def test_the_engine_uses_the_one_differ():
    from ntxent_tpu.analysis.graph import recompile as jrecompile
    from ntxent_tpu_torch.serving import engine

    assert engine.RecompileDiffer is trecompile.RecompileDiffer
    assert not (REPO / "ntxent_tpu_torch/serving/_causes.py").exists()
    signatures = [("a", {"structure": 1, "dtype": "f", "shape": 4}),
                  ("b", {"structure": 1, "dtype": "f", "shape": 8}),
                  ("c", {"structure": 1, "dtype": "i", "shape": 8}),
                  ("b", {"structure": 1, "dtype": "f", "shape": 8}),
                  ("d", {"structure": 2, "dtype": "f", "shape": 8,
                         "version": 3})]
    port, ref = trecompile.RecompileDiffer(), jrecompile.RecompileDiffer()
    assert [port.observe(k, s) for k, s in signatures] == \
        [ref.observe(k, s) for k, s in signatures]


# ---------------------------------------------------------------------------
# publication: the timelines render the same series


@pytest.mark.parametrize("graph", [
    {"graph_bytes": 264.0, "declared_bytes": 132.0, "ad_bytes": 132.0},
    {"graph_bytes": 96.0, "declared_bytes": 0.0, "ad_bytes": 12.5,
     "gspmd_bytes": 40.0},
])
def test_set_comms_per_step_renders_as_jax(graph):
    from ntxent_tpu import obs as jobs
    from ntxent_tpu_torch import obs as tobs

    profile = {("all_gather", "data"): (2, 128.0), ("psum", "data"): (1, 4.0)}
    lines, events = [], []
    for obs in (jobs, tobs):
        registry = obs.MetricsRegistry()
        log = obs.EventLog(None)
        previous = obs.install(log)
        try:
            obs.StepTimeline(registry=registry).set_comms_per_step(
                profile, graph=graph)
        finally:
            obs.install(previous)
        lines.append(sorted(line for line in
                            registry.render_prometheus().splitlines()
                            if "collective_graph" in line
                            or "train_step_comms" in line))
        (event,) = [e for e in log.tail(5) if e["event"] == "comms_profile"]
        events.append({k: v for k, v in event.items()
                       if k not in ("t", "wall", "run_id")})
    assert lines[0] == lines[1]
    assert events[0] == events[1]


def test_a_world_of_one_publishes_the_ad_series_at_zero():
    """The one difference from JAX's publication: a census summary with
    no autograd traffic (a world of one prices every collective at 0
    bytes) still publishes ``{source="ad"} 0``, so a scrape tells a
    census that ran from none; JAX skips the zero."""
    from ntxent_tpu import obs as jobs
    from ntxent_tpu_torch import obs as tobs

    graph = {"graph_bytes": 0.0, "declared_bytes": 0.0, "ad_bytes": 0.0}
    got = []
    for obs in (jobs, tobs):
        registry = obs.MetricsRegistry()
        obs.StepTimeline(registry=registry).set_comms_per_step({}, graph)
        got.append(registry.collect().get("collective_graph_bytes_total"))
    assert got == [None, {'{source="ad"}': 0.0}]


def test_graph_census_true_without_a_timeline_raises():
    from ntxent_tpu_torch.training import train_loop

    with pytest.raises(ValueError, match="requires timeline"):
        train_loop(None, iter(()), None, 1, graph_census=True)


# ---------------------------------------------------------------------------
# the CLI


def _audit(*argv, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m",
                           "ntxent_tpu_torch.analysis.graph.cli", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_world_of_two_is_clean_on_the_real_tree():
    done = _audit("--world", "2", "--format", "json", "--no-publish")
    assert done.returncode == 0, done.stderr[-2000:]
    report = json.loads(done.stdout)
    assert report["new"] == [] and report["stale_baseline"] == []
    assert report["census"]["dist_loss/grad"]["ad_bytes"] == 132.0
    assert report["census"]["_remainder"]["gspmd_bytes"] == 0.0


def test_cli_usage_errors_and_events(tmp_path):
    assert _audit("--analyzers", "nope").returncode == 2
    assert _audit("--analyzers", "recompile-cause").returncode == 2
    assert _audit("--events", "x.jsonl", "--analyzers",
                  "donation").returncode == 2
    assert _audit("--world", "0").returncode == 2
    log = tmp_path / "run.jsonl"
    log.write_text("\n".join(json.dumps(e) for e in CHURN_STREAMS[1])
                   + "\n")
    done = _audit("--analyzers", "recompile-cause", "--events", str(log),
                  "--no-baseline")
    assert done.returncode == 1
    assert "[recompile-cause]" in done.stdout
    base = tmp_path / "audit_baseline.json"
    assert _audit("--analyzers", "recompile-cause", "--events", str(log),
                  "--baseline", str(base),
                  "--write-baseline").returncode == 0
    done = _audit("--analyzers", "recompile-cause", "--events", str(log),
                  "--baseline", str(base))
    assert done.returncode == 0, done.stdout
    listed = _audit("--list-analyzers")
    assert listed.returncode == 0
    assert [ln for ln in listed.stdout.splitlines()
            if not ln.startswith(" ")] == ["collective-census", "wire-dtype",
                                           "donation", "recompile-cause"]


def test_the_committed_audit_baseline_is_empty():
    data = json.loads((REPO / "ntxent_tpu_torch/analysis/"
                       "audit_baseline.json").read_text())
    assert data == {"version": 1, "findings": []}


def test_default_targets_mirror_the_jax_suite():
    """The JAX suite's names, with ``gspmd/matmul`` as ``tp/matmul`` (no
    compiler inserts the port's collectives)."""
    from ntxent_tpu.analysis.graph.targets import (
        default_targets as jax_targets,
    )

    jax_names = [t.name for t in jax_targets(mesh=object())]
    port = [t.name for t in default_targets()]
    assert port == [("tp/matmul" if n == "gspmd/matmul" else n)
                    for n in jax_names]
