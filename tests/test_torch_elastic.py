"""The port's elastic restart against the JAX package's
(``tests/test_elastic.py``), wherever it has a meaning over ``c10d``.

A rank of the port is one process on one device, so a world changes size
at the process boundary: a step saved at world P restores at world Q,
and ``resilience.crashsim``'s elastic audit relaunches the lineage at
each size of its schedule. Here:

* the topology sidecar of a step, and a restore onto a smaller world
  counted as a re-shard (``checkpoint_reshard_total``,
  ``checkpoint_reshard_ms``, ``reshard="gather_replace"`` on the restore
  event; JAX's ``_topology_differs`` gives the same verdict on the same
  records), a matching world not counted;
* the ``shrink``/``grow`` plan and its injector against JAX's, the
  supervisor's ``topology_hook`` between attempts (and without one, and
  one that raises);
* ``parse_schedule`` against JAX's, and the audit's refusal of an entry
  of several devices a process;
* JAX's checkpoints of the tiny ResNet SimCLR saved on a mesh of 4
  devices, restored by JAX onto a mesh of 2 (``_place_elastic``,
  ``_from_bytes_tolerant``) and by the port in a gloo world of 2
  (``torch_mp_workers.run_elastic``): a ZeRO-3 state re-cut from its
  whole copy into 2 slices, equal to JAX's placed values (1e-6: a flax
  kernel and the torch weight are the same numbers in another layout),
  and an error-feedback residual saved at world 4 reset to zeros in both;
* the CLI's elastic seam: ``shrink@K`` in a single process restarts on
  the same world and says why;
* one ``CrashAudit(device="cpu", model="tiny").elastic((4, 2, 4))`` over
  gloo: JAX's default schedule is 8, 4, 8; a world of 4 processes is the
  most this suite runs beside the others, so the lineage is cut to 4, 2,
  4, within its own limit of ``AUDIT_LIMIT_S`` (it takes ~30 s on one
  thread a rank).
"""

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntxent_tpu.parallel.fsdp import shard_train_state_fsdp as jshard
from ntxent_tpu.parallel.mesh import replicate_state as jreplicate
from ntxent_tpu.resilience import FaultInjector as JaxInjector
from ntxent_tpu.resilience import FaultPlan as JaxPlan
from ntxent_tpu.resilience.crashsim import parse_schedule as jax_schedule
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.checkpoint import _topology_differs
from ntxent_tpu.training.trainer import (
    init_error_feedback as jinit_ef,
)
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.obs import events
from ntxent_tpu_torch.obs.registry import default_registry
from ntxent_tpu_torch.resilience import (
    FaultInjector,
    FaultPlan,
    Supervisor,
)
from ntxent_tpu_torch.resilience.crashsim import (
    CrashAudit,
    CrashAuditError,
    parse_schedule,
    restore_reshards_from_jsonl,
)
from ntxent_tpu_torch.resilience.faults import TopologyChange
from ntxent_tpu_torch.training import CheckpointManager
from ntxent_tpu_torch.training import checkpoint as tcheckpoint

import torch_mp_workers as workers
from test_torch_checkpoint import _state
from test_torch_distributed import _spawn
from test_torch_fsdp import _jax_resnet, _rank_model
from test_torch_fsdp import _state as _jax_state
from test_torch_moe import STEP_CONFIG, _assert_params, _np

pytestmark = pytest.mark.elastic

torch.set_num_threads(1)  # see test_torch_training.py

# the audit's own limit on the CPU, and each child's
AUDIT_LIMIT_S = 90
CHILD_TIMEOUT_S = 60
TINY = dict(device="cpu", model="tiny", image_size=8, batch=8)
RESTORE_WORLD = 2


def _reshards():
    return (default_registry().counter("checkpoint_reshard_total", "")
            .value,
            default_registry().histogram("checkpoint_reshard_ms", "")
            .count)


@pytest.fixture
def event_log(tmp_path):
    path = tmp_path / "events.jsonl"
    previous = events.install(events.EventLog(str(path)))
    try:
        yield path
    finally:
        events.install(previous)


def _save_at_world(monkeypatch, root, state, step, device_count):
    """Save ``state`` as a world of ``device_count`` ranks records it."""
    record = dict(tcheckpoint._mesh_record(), device_count=device_count)
    with monkeypatch.context() as m:
        m.setattr(tcheckpoint, "_mesh_record", lambda: record)
        manager = CheckpointManager(root)
        assert manager.save(step, state, force=True)
        manager.close()


# ---------------------------------------------------------------------------
# the topology sidecar and the reshard pair


def test_topology_sidecar_round_trip(tmp_path):
    state = _state()
    manager = CheckpointManager(tmp_path / "ckpt")
    assert manager.save(5, state, force=True)
    manager.close()
    sidecar = json.loads((tmp_path / "ckpt" / "5" / "topology.json")
                         .read_text())
    assert sidecar["mesh"]["device_count"] == 1
    assert sidecar["specs"] and set(sidecar["specs"].values()) == {None}
    manifest = json.loads((tmp_path / "ckpt" / "manifests.json").read_text())
    assert "topology.json" in manifest["5"]["files"]


def test_restore_onto_a_smaller_world_is_a_reshard(tmp_path, monkeypatch,
                                                   event_log):
    """A step saved at world 2 restores at world 1: the same values, the
    pair counted and the event marked, as JAX's verdict on the records."""
    state = _state()
    _save_at_world(monkeypatch, tmp_path / "ckpt", state, 5, 2)
    saved = json.loads((tmp_path / "ckpt" / "5" / "topology.json")
                       .read_text())["mesh"]
    assert _topology_differs(saved, tcheckpoint._mesh_record())
    before = _reshards()
    target = _state(seed=1)
    manager = CheckpointManager(tmp_path / "ckpt")
    manager.restore(target)
    manager.close()
    after = _reshards()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for a, b in zip(target.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    assert restore_reshards_from_jsonl(event_log) == ["gather_replace"]


def test_matching_world_restore_is_not_a_reshard(tmp_path, event_log):
    state = _state()
    manager = CheckpointManager(tmp_path / "ckpt")
    assert manager.save(5, state, force=True)
    before = _reshards()
    manager.restore(_state(seed=1))
    manager.close()
    assert _reshards() == before
    assert not _topology_differs(tcheckpoint._mesh_record(),
                                 tcheckpoint._mesh_record())
    assert restore_reshards_from_jsonl(event_log) == ["none"]


# ---------------------------------------------------------------------------
# shrink@K / grow@K and the supervisor's hook


def test_fault_plan_parses_shrink_grow_as_jax():
    for spec in ("shrink@5,grow@9,nan@3", "grow@2"):
        plan, ref = FaultPlan.parse(spec), JaxPlan.parse(spec)
        assert (plan.shrink_batches, plan.grow_batches) == \
            (ref.shrink_batches, ref.grow_batches)
    with pytest.raises(ValueError, match="shrink"):
        FaultPlan.parse("shrink@zero")


def test_injector_raises_topology_change_as_jax():
    def trail(injector):
        batches = iter(injector.wrap_iterator(iter(range(10))))
        out = []
        for _ in range(5):
            try:
                out.append(next(batches))
            except Exception as e:  # TopologyChange of either package
                out.append((type(e).__name__, e.action, e.batch))
        return out, injector.fired

    port = trail(FaultInjector(FaultPlan.parse("shrink@2,grow@4")))
    ref = trail(JaxInjector(JaxPlan.parse("shrink@2,grow@4")))
    assert port == ref
    assert port[1] == ["shrink@2", "grow@4"]


class _Done:
    step = 10


def test_supervisor_topology_hook_rebuilds_between_attempts():
    """The hook runs before the next attempt, the record carries the
    action, the run completes on the rebuilt world, and each rebuild is
    counted."""
    calls, world = [], {"devices": 8}
    counter = default_registry().counter(
        "supervisor_topology_restarts_total", "")
    before = counter.value

    def run_attempt(attempt, stop_fn, watchdog):
        if attempt == 0:
            assert world["devices"] == 8
            raise TopologyChange("shrink", 5)
        if attempt == 1:
            assert world["devices"] == 4  # the hook ran first
            raise TopologyChange("grow", 9)
        assert world["devices"] == 8
        return _Done(), [{"step": 10}]

    def hook(action):
        calls.append(action)
        world["devices"] = 4 if action == "shrink" else 8

    result = Supervisor(run_attempt, num_steps=10, max_restarts=3,
                        topology_hook=hook, sleep=lambda _s: None).run()
    assert result.completed and calls == ["shrink", "grow"]
    assert [r.topology for r in result.records] == ["shrink", "grow", None]
    assert counter.value - before == 2


@pytest.mark.parametrize("hook", [None, "raises"])
def test_supervisor_topology_without_a_working_hook_restarts_unchanged(
        hook, caplog):
    attempts = []

    def run_attempt(attempt, stop_fn, watchdog):
        attempts.append(attempt)
        if attempt == 0:
            raise TopologyChange("shrink", 3)
        return _Done(), []

    def broken(action):
        raise RuntimeError("no devices")

    with caplog.at_level(logging.WARNING):
        result = Supervisor(run_attempt, num_steps=10, max_restarts=1,
                            topology_hook=broken if hook else None,
                            sleep=lambda _s: None).run()
    assert result.completed and attempts == [0, 1]
    assert result.records[0].topology == "shrink"
    assert "unchanged world" in caplog.text


# ---------------------------------------------------------------------------
# the schedule


@pytest.mark.parametrize("spec", ["8,4,8", "8, 4x2 ,8", "4,2,4", "2x2"])
def test_parse_schedule_equals_jax(spec):
    assert parse_schedule(spec) == jax_schedule(spec)


@pytest.mark.parametrize("spec,match", [
    ("8,four", "DEVICESxPROCESSES"), ("8x3", "multiple of processes"),
    ("0x1", "multiple of processes"), (" , ", "empty")])
def test_parse_schedule_refuses_as_jax(spec, match):
    with pytest.raises(ValueError, match=match):
        parse_schedule(spec)
    with pytest.raises(ValueError, match=match):
        jax_schedule(spec)


@pytest.mark.parametrize("schedule,match", [
    ([(4, 2), 2], "one process on one device"),
    ([3, 2], "does not split over 3 ranks")])
def test_elastic_refuses_entries_the_port_cannot_run(tmp_path, schedule,
                                                     match):
    with pytest.raises(CrashAuditError, match=match):
        CrashAudit(tmp_path, **TINY).elastic(schedule)
    assert not (tmp_path / "elastic_ref").exists()


# ---------------------------------------------------------------------------
# ZeRO-3 and the error-feedback residual across worlds, against JAX


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


@pytest.fixture(scope="module")
def recut(tmp_path_factory):
    """JAX saves the tiny ResNet SimCLR on a mesh of 4 (ZeRO-3, and
    replicated with a residual of twos); a gloo world of 2 restores both
    while JAX restores them onto a mesh of 2."""
    tmp = tmp_path_factory.mktemp("elastic_recut")
    jmodel = _jax_resnet()
    variables = _np(jmodel.init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 16, 16, 3)), train=False))
    mesh4, mesh2 = _jax_mesh(4), _jax_mesh(RESTORE_WORLD)
    zero3, ef = tmp / "zero3", tmp / "ef"
    JaxManager(str(zero3)).save(
        0, jshard(_jax_state(jmodel, variables), mesh4), force=True)
    with_ef = jinit_ef(jreplicate(_jax_state(jmodel, variables), mesh4),
                       mesh4)
    with_ef = with_ef.replace(ef_residual=jax.tree.map(
        lambda e: jax.device_put(np.full(e.shape, 2.0, np.float32),
                                 e.sharding), with_ef.ef_residual))
    JaxManager(str(ef), save_ef_residual=True).save(0, with_ef, force=True)
    inputs = {"zero3_ckpt": np.array(str(zero3)),
              "ef_ckpt": np.array(str(ef)),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()}}
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(_spawn, workers.run_elastic, RESTORE_WORLD,
                             (str(tmp / "inputs.npz"), str(tmp)), tmp)
        jax_zero3 = JaxManager(str(zero3)).restore(
            jshard(_jax_state(jmodel, variables), mesh2))
        template = jinit_ef(jreplicate(_jax_state(jmodel, variables),
                                       mesh2), mesh2)
        jax_ef = JaxManager(str(ef), save_ef_residual=True).restore(template)
        future.result()
    ranks = [dict(np.load(tmp / f"rank{r}.npz"))
             for r in range(RESTORE_WORLD)]
    return dict(ranks=ranks, jax_zero3=jax_zero3, jax_ef=jax_ef,
                variables=variables)


def test_zero3_state_recut_to_a_new_world_equals_jax(recut):
    """Each rank of the world of 2 holds its half of every cut parameter,
    and the whole copy they gather is JAX's restore onto its mesh of 2."""
    jax_zero3 = recut["jax_zero3"]
    assert {s.mesh.size for s in jax.tree.leaves(jax.tree.map(
        lambda a: a.sharding, jax_zero3.params))} == {RESTORE_WORLD}
    cut = 0
    for rank, res in enumerate(recut["ranks"]):
        assert int(res["zero3_reshards"]) == 1
        assert int(res["zero3_step"]) == int(jax_zero3.step) == 0
        model = _rank_model(res, "zero3", workers.resnet_simclr())
        _assert_params(model, jax_zero3.params, atol=1e-6)
        whole = dict(model.named_parameters())
        for key in [k for k in res if k.startswith("slice:")]:
            name = key[len("slice:"):]
            dim = int(res[f"dim:{name}"])
            want = whole[name].detach().numpy()
            if dim >= 0:
                want = np.split(want, RESTORE_WORLD, axis=dim)[rank]
                cut += 1
            np.testing.assert_array_equal(res[key], want)
    assert cut > 0


def test_error_feedback_residual_from_another_world_resets_as_jax(recut):
    """Saved at world 4 with every entry 2.0: JAX's tolerant restore onto
    a mesh of 2 and the port's in a world of 2 both start at zero
    residual; the parameters restore as saved."""
    jax_ef = recut["jax_ef"]
    assert all(float(jnp.abs(e).max()) == 0.0
               for e in jax.tree.leaves(jax_ef.ef_residual))
    for res in recut["ranks"]:
        assert int(res["ef_reshards"]) == 1
        assert float(res["ef_residual_max"]) == 0.0
        model = _rank_model(res, "ef_model", workers.resnet_simclr())
        _assert_params(model, jax_ef.params, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI's seam and the audit


def test_cli_shrink_restarts_on_the_same_world_and_says_why(tmp_path,
                                                            caplog):
    argv = ["train", "--device", "cpu", "--model", "tiny", "--image-size",
            "8", "--batch", "8", "--steps", "3", "--log-every", "1",
            "--proj-hidden-dim", "16", "--proj-dim", "8",
            "--synthetic-samples", "16", "--warmup-steps", "1",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "1",
            "--chaos", "shrink@2", "--max-restarts", "1"]
    args = cli.build_train_parser().parse_args(argv[1:])
    with caplog.at_level(logging.WARNING):
        state, _ = cli.train(args)
    assert state.step == 3
    assert "no in-process topology builder" in caplog.text
    assert "no topology_hook" in caplog.text


def test_elastic_audit_over_gloo_worlds_4_2_4(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    t0 = time.monotonic()
    summary = CrashAudit(tmp_path, steps=8, timeout_s=CHILD_TIMEOUT_S,
                         **TINY).elastic((4, 2, 4))
    assert time.monotonic() - t0 < AUDIT_LIMIT_S
    assert summary["verdict"] == "PASS:loss_continuity"
    assert summary["device_counts"] == [4, 2, 4]
    assert summary["kills"] == 2 and summary["final_step"] == 8
    # Each restore re-places the state exactly when the step it restored
    # was saved at another world. Which step that is depends on timing:
    # a kill at batch K leaves steps up to K - 2 of the incarnation on
    # disk for certain and step K - 1 only if its background write
    # landed, so an incarnation killed at batch 2 may leave none and its
    # successor restore the world before it.
    for inc in summary["incarnations"][1:]:
        step = inc["resumed_from"]
        want = []
        if step:
            saved = json.loads((tmp_path / "elastic0" / str(step) /
                                "topology.json").read_text())
            want = ["gather_replace" if saved["mesh"]["device_count"]
                    != inc["devices"] else "none"]
        assert inc["reshards"] == want, inc
    assert "gather_replace" in [r for inc in summary["incarnations"]
                                for r in inc["reshards"]]
    assert summary["loss_continuity"]["steps_compared"] == 8
    assert json.loads((tmp_path / "elastic_summary.json").read_text()) == \
        summary
