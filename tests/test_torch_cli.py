"""``ntxent-train`` of the port for ResNet SimCLR and its data-parallel
flags, on the CPU (the run of a gloo world of 2 is in
``test_torch_distributed.py``)."""

import json

import numpy as np
import pytest
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import ResNet
from ntxent_tpu_torch.ops import ntxent

torch.set_num_threads(1)  # see test_torch_training.py

TINY_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
             "--batch", "4", "--steps", "2", "--log-every", "1",
             "--proj-hidden-dim", "16", "--proj-dim", "8",
             "--synthetic-samples", "8", "--warmup-steps", "1"]


def test_default_model_is_resnet50_as_in_the_jax_cli():
    args = cli.build_train_parser().parse_args([])
    assert (args.model, args.stem, args.dp_loss, args.collective_dtype) == (
        "resnet50", "conv", "strip", "float32")
    args.image_size = 224
    encoder = cli.build_model(args).backbone
    assert isinstance(encoder, ResNet) and encoder.hidden_dim == 2048
    assert not encoder.small_images
    args.image_size = 64  # the CIFAR stem at 64 px and below
    assert cli.build_model(args).backbone.small_images


@pytest.mark.parametrize("model,width", [("tiny", 256), ("resnet18", 512),
                                         ("resnet50x2", 4096)])
def test_resnet_models_of_the_cli(model, width):
    args = cli.build_train_parser().parse_args(["--model", model])
    args.image_size = 32
    assert cli.build_model(args).backbone.hidden_dim == width


def test_tiny_resnet_trains_on_one_cpu_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = cli.build_train_parser().parse_args(TINY_ARGV)
    before = {k: v.clone() for k, v in
              cli.build_model(args).state_dict().items()}
    launches = ntxent.ntxent_fwd_general.launches
    state, history = cli.train(args)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    after = state.model.state_dict()
    assert any((after[k] - before[k]).abs().max() > 0 for k in before
               if k.endswith("running_mean"))
    # a world of one takes the single-card step, not the strip loss
    assert ntxent.ntxent_fwd_general.launches == launches


# ROADMAP.md items a later slice ported: their flags now run, and a run
# on one card warns that it ignores them, as the JAX CLI does
# (``cli.py:914-932``). Queue A 6(b) (the space-to-depth stem) and 11(b)
# (train-side telemetry) are done too: their flags train and do their job;
# so is Queue A 9 (model parallelism and MoE): on one process its flags
# warn as the JAX CLI's do on one device, and ``--coordinator`` without
# its partners exits as JAX's rendezvous does (``DONE_EXITS``).
DONE_ITEMS = (r"Queue A 3\(d\)", r"Queue A 3\(e\)", r"Queue A 6\(b\)",
              r"Queue A 11\(b\)", "Queue A 9")
DONE_EXITS = {"--coordinator": "--num-processes and --process-id"}
# the one-card warning of each such flag (none for --ring-chunks with the
# default --dp-loss strip: the JAX CLI warns only in a data-parallel run)
ONE_CARD_WARNINGS = {"--dp-loss": "--dp-loss chunked ignored",
                     "--collective-dtype": "--collective-dtype bf16 ignored",
                     "--measure-overlap": "--measure-overlap ignored",
                     "--ring-chunks": None, "--stem": None,
                     "--metrics-port": None, "--log-jsonl": None,
                     "--trace-dir": None, "--trace-steps": None,
                     "--slow-step-factor": None,
                     "--parallel": "--parallel tp ignored",
                     "--fsdp": "--fsdp ignored", "--model-par": None,
                     "--tp-loss-axes": "--tp-loss-axes both ignored",
                     "--moe-aux-weight": None,
                     "--num-processes": "single-process mode",
                     "--process-id": "single-process mode",
                     "--dcn-slices": None}
# what a done flag needs besides TINY_ARGV: the stem is a ResNet's ImageNet
# stem, so a ResNet-18 above the CIFAR stem's 64 px
ONE_CARD_EXTRA = {"--stem": ["--model", "resnet18", "--image-size", "72"]}


def _trains_on_one_card(args, flag, caplog, monkeypatch, tmp_path):
    """A done flag trains on one card (in ``tmp_path``: relative telemetry
    paths land there) and shows its effect."""
    warning = ONE_CARD_WARNINGS[flag]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.chdir(tmp_path)
    launches = ntxent.ntxent_fwd_general.launches
    with caplog.at_level("INFO"):
        state, history = cli.train(args)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert ntxent.ntxent_fwd_general.launches == launches  # one card's step
    if warning is not None:
        assert warning in caplog.text
    if flag == "--stem":
        assert type(state.model.backbone.stem_conv).__name__ \
            == "SpaceToDepthStem"
    if flag == "--metrics-port":
        assert "metrics endpoint: http://127.0.0.1:" in caplog.text
    if flag == "--log-jsonl":
        steps = [json.loads(line) for line in open(tmp_path / args.log_jsonl)
                 if '"step"' in line]
        assert [r["step"] for r in steps if r["event"] == "step"] == [1, 2]
    if flag == "--trace-dir":
        assert (tmp_path / args.trace_dir).is_dir()
        assert "profiler armed" in caplog.text
    if flag in ("--trace-steps", "--slow-step-factor"):
        # without --trace-dir they arm nothing, as in the JAX CLI
        assert "profiler armed" not in caplog.text


@pytest.mark.parametrize("flags,match", [
    (["--dp-loss", "chunked"], r"Queue A 3\(d\)"),
    (["--stem", "space_to_depth"], r"Queue A 6\(b\)"),
    (["--collective-dtype", "bf16"], r"Queue A 3\(e\)"),
    (["--parallel", "tp"], "Queue A 9"),
    (["--fsdp"], "Queue A 9"),
], ids=lambda f: "_".join(f) if isinstance(f, list) else None)
def test_unported_data_parallel_flags_exit_naming_their_item(
        flags, match, caplog, monkeypatch, tmp_path):
    """Unported flags exit naming their item; those of a done item
    (``DONE_ITEMS``: chunked, the wire dtypes and the stem, ported since)
    train on one card with the JAX CLI's warning
    (``ONE_CARD_WARNINGS``)."""
    args = cli.build_train_parser().parse_args(
        TINY_ARGV + flags + ONE_CARD_EXTRA.get(flags[0], []))
    if match in DONE_ITEMS:
        _trains_on_one_card(args, flags[0], caplog, monkeypatch, tmp_path)
        return
    with pytest.raises(SystemExit, match=f"ROADMAP.md {match}"):
        cli.train(args)


def test_vit_attention_applies_to_vit_encoders_only():
    args = cli.build_train_parser().parse_args(
        TINY_ARGV + ["--vit-attention", "flash"])
    with pytest.raises(SystemExit, match="ViT encoders only"):
        cli.train(args)


def test_data_parallel_checks_come_before_the_process_group(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="must divide across 3"):
        cli.train(cli.build_train_parser().parse_args(TINY_ARGV))
    # CLIP's data-parallel branch (ported) checks its --batch (256) first
    with pytest.raises(SystemExit, match="must divide across 3"):
        cli.train(cli.build_train_parser().parse_args(
            ["--objective", "clip", "--model", "tiny", "--device", "cpu"]))


def test_torchrun_environment_is_required_to_join(monkeypatch):
    from ntxent_tpu_torch.parallel import mesh

    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        mesh.init_from_env("cpu")


@pytest.mark.parametrize("impl,error,match", [
    ("pair", None, None),
    ("chunked", NotImplementedError, r"Queue A 3\(d\)"),
    ("ring", ValueError, "unknown NT-Xent impl")])
def test_only_the_strip_schedule_is_ported(impl, error, match):
    """The strip, pair (since the pair slice) and chunked (since Queue A
    3(d), which ``match`` names; its ``error`` is no longer raised)
    schedules resolve; an unknown name raises as unknown."""
    from ntxent_tpu_torch.parallel import dist_loss, pair

    assert dist_loss.resolve_local_ntxent("strip") is \
        dist_loss.local_ntxent_allgather
    if error is None:
        assert dist_loss.resolve_local_ntxent(impl) is pair.pair_body
        return
    if match in DONE_ITEMS:
        loss = dist_loss.make_sharded_ntxent(None, 0.1, impl=impl)
        assert loss.func is dist_loss.local_ntxent_chunked
        assert not hasattr(dist_loss, "NOT_PORTED")
        return
    with pytest.raises(error, match=match):
        dist_loss.make_sharded_ntxent(None, 0.1, impl=impl)


def test_row_ids_and_comms_accounting_without_a_group():
    from ntxent_tpu_torch.parallel import mesh

    assert mesh.local_row_gids(2, 3, 4).tolist() == [6, 7, 8, 18, 19, 20]
    assert mesh.process_info() == {"process_index": 0, "process_count": 1,
                                   "local_device_count": 1,
                                   "global_device_count": 1}
    acct = mesh.CommsAccounting()
    acct.record("psum", "data", 6.0)
    mark = acct.totals()
    acct.record("psum", "data", 2.0)
    acct.record("all_gather", "data", 8.0, calls=2)
    assert acct.delta(mark) == {("psum", "data"): (1, 2.0),
                                ("all_gather", "data"): (2, 8.0)}
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.psum(torch.ones(2))


# Every flag the JAX CLI's parsers take and the port did not run, set to a
# value other than the JAX default, with the ROADMAP.md item its exit
# names (a done item's flags run: ``DONE_ITEMS``).
TRAIN_FLAGS = [
    (["--ring-chunks", "4"], r"Queue A 3\(d\)"),  # done: runs, see below
    (["--measure-overlap"], r"Queue A 3\(d\)"),   # done: runs, warned
    (["--model-par", "4"], "Queue A 9"),
    (["--tp-loss-axes", "both"], "Queue A 9"),
    (["--moe-aux-weight", "0.05"], "Queue A 9"),
    (["--coordinator", "host:1234"], "Queue A 9"),
    (["--num-processes", "2"], "Queue A 9"),
    (["--process-id", "1"], "Queue A 9"),
    (["--dcn-slices", "2"], "Queue A 9"),
    (["--metrics-port", "0"], r"Queue A 11\(b\)"),
    (["--log-jsonl", "run.jsonl"], r"Queue A 11\(b\)"),
    (["--trace-dir", "traces"], r"Queue A 11\(b\)"),
    (["--trace-steps", "3"], r"Queue A 11\(b\)"),
    (["--slow-step-factor", "2"], r"Queue A 11\(b\)"),
]
SERVE_FLAGS = [
    (["--stem", "space_to_depth", "--image-size", "224"],
     r"Queue A 6\(b\)"),
]


@pytest.mark.parametrize(
    "command,flags,match",
    [("train", f, m) for f, m in TRAIN_FLAGS]
    + [("serve", f, m) for f, m in SERVE_FLAGS],
    ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_reference_flags_parse_and_exit_naming_their_item(
        command, flags, match, caplog, monkeypatch, tmp_path):
    """Each flag parses (no "unrecognized arguments" or "invalid choice")
    and, set, exits naming its ROADMAP.md item before any work; a flag of
    a done item (``DONE_ITEMS``) trains on one card instead, with its
    ``ONE_CARD_WARNINGS``, or (serve ``--stem``) serves a ResNet-18 through
    the space-to-depth stem."""
    if command == "train":
        args = cli.build_train_parser().parse_args(TINY_ARGV + flags)
        run = cli.train
        if flags[0] in DONE_EXITS:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
            with pytest.raises(SystemExit, match=DONE_EXITS[flags[0]]):
                run(args)
            return
        if match in DONE_ITEMS:
            _trains_on_one_card(args, flags[0], caplog, monkeypatch,
                                tmp_path)
            return
    else:
        args = cli.build_serve_parser().parse_args(
            ["--device", "cpu", "--model", "tiny", "--port", "0"] + flags)
        run = cli.build_server
        if match in DONE_ITEMS:
            _serves_with_the_stem(flags)
            return
    with pytest.raises(SystemExit, match=f"ROADMAP.md {match}"):
        run(args)


def _serves_with_the_stem(flags):
    """serve ``--stem space_to_depth`` builds a ResNet-18 whose stem is
    ``SpaceToDepthStem`` (at 72 px: the ImageNet stem above the CIFAR
    stem's 64) and embeds a row as the conv stem of the same weights
    does, within the serve path's bf16 tolerance."""
    base = ["--device", "cpu", "--model", "resnet18", "--port", "0",
            "--buckets", "1", "--no-warmup", "--head", "embedding"]
    servers = {stem: cli.build_server(cli.build_serve_parser().parse_args(
        base + flags + ["--image-size", "72", "--stem", stem]))
        for stem in ("space_to_depth", "conv")}
    try:
        model = servers["space_to_depth"].engine.model
        assert type(model.backbone.stem_conv).__name__ == "SpaceToDepthStem"
        x = np.random.default_rng(3).uniform(
            size=(1, 72, 72, 3)).astype(np.float32)
        got, want = (np.asarray(servers[s].engine.embed(x))
                     for s in ("space_to_depth", "conv"))
    finally:
        for server in servers.values():
            server.close()
    assert got.shape == want.shape and got.shape[0] == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


# The serve flags this port runs (each exited naming its ROADMAP.md item
# before): every one parses, builds a server on the CPU through
# build_server, answers /embed, and shows its effect.
SERVE_TINY = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
              "--buckets", "1,4", "--port", "0", "--proj-hidden-dim", "16",
              "--proj-dim", "8", "--head", "embedding"]


SERVE_LIMIT_S = 60.0  # each HTTP case's own time limit


def _within_limit(fn, limit_s: float):
    """Run ``fn`` on a daemon thread; fail if it is not done in
    ``limit_s``, so a hang fails the case instead of cutting the run."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(limit_s)
    assert not thread.is_alive(), f"no result within {limit_s} s: a hang"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _serve_post(server, rows=3):
    import urllib.request

    x = np.random.default_rng(rows).uniform(size=(rows, 8, 8, 3))
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/embed", method="POST",
        data=json.dumps({"inputs": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
        assert resp.status == 200 and body["rows"] == rows
        assert np.all(np.isfinite(body["embeddings"]))
        return dict(resp.headers), body


def _serve_get(server, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}",
                                timeout=60) as resp:
        return resp.read().decode()


def _supervised(server, check):
    """``check`` while ``serve_forever`` runs in a thread; then a clean
    shutdown."""
    import threading
    import time

    result = {}
    unsupervised = server.batcher  # start()'s, which the attempt replaces
    loop = threading.Thread(
        target=lambda: result.setdefault("ok", server.serve_forever()))
    loop.start()
    deadline = time.monotonic() + 10
    while server.batcher in (None, unsupervised) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    try:
        check()
    finally:
        server.shutdown()
        loop.join(20)
    assert result.get("ok") is True


def _check_adaptive(server, args):
    engine = server.engine
    assert engine.adaptive and engine.histogram is not None
    for rows in (3, 3, 3):
        _serve_post(server, rows)
    assert engine.refresh_ladder(force=True)
    assert engine.buckets == (3, 4)
    _serve_post(server, 3)
    assert engine.metrics.to_dict()["ladder"]["generation"] == 1


def _check_ladder_knob(attr, want):
    def check(server, args):
        assert getattr(server.engine, attr) == want
        _serve_post(server)
    return check


def _check_ladder_interval(server, args):
    engine = server.engine
    assert args.ladder_interval == 0.5
    assert engine._ladder_thread is None  # only with --adaptive-buckets
    _serve_post(server)


def _check_max_restarts(server, args):
    assert server.max_restarts == 2
    _supervised(server, lambda: _serve_post(server))


def _check_stall_timeout(server, args):
    assert server.stall_timeout_s == 5.0

    def check():
        _serve_post(server)
        health = json.loads(_serve_get(server, "/healthz"))
        assert health["status"] == "serving"
        assert server._watchdog is not None \
            and server._watchdog.timeout_s == 5.0

    _supervised(server, check)


def _check_port_file(server, args):
    assert server.listening and server.ready
    with open(args.port_file) as f:
        assert int(f.read()) == server.port
    _serve_post(server)


def _check_watch(server, args):
    watcher = server.reloader
    assert watcher is not None and watcher.current_step is None
    assert (watcher.poll_s, watcher.delay_s) == (args.watch_poll,
                                                args.watch_delay)
    headers, _ = _serve_post(server)
    assert "X-Checkpoint-Step" not in headers  # random weights


def _check_log_jsonl(server, args):
    from ntxent_tpu_torch.obs import events

    headers, _ = _serve_post(server)
    server.close()
    names = {r["name"] for r in events.read_events(args.log_jsonl, "span")
             if r.get("request_id") == headers["X-Request-Id"]}
    assert {"serve.request", "serve.queue_wait"} <= names


def _check_run_id(server, args):
    _serve_post(server)
    assert 'serving_run_info{run_id="abc"} 1' in _serve_get(
        server, "/metrics?format=prometheus")
    assert json.loads(_serve_get(server, "/metrics"))["run_id"] == "abc"


def _check_int8(server, args):
    assert server.engine.quantized
    _serve_post(server, 4)
    assert server.engine.h2d_bytes == 4 * 8 * 8 * 3 + 4 * 4


LIFTED_SERVE_FLAGS = [
    (["--adaptive-buckets"], _check_adaptive),
    (["--ladder-max-buckets", "4"],
     _check_ladder_knob("ladder_max_buckets", 4)),
    (["--ladder-min-requests", "30"],
     _check_ladder_knob("ladder_min_requests", 30)),
    (["--ladder-interval", "0.5"], _check_ladder_interval),
    (["--max-restarts", "2"], _check_max_restarts),
    (["--stall-timeout", "5"], _check_stall_timeout),
    (["--port-file", "{tmp}/port"], _check_port_file),
    (["--watch-ckpt", "--ckpt-dir", "{tmp}/ck"], _check_watch),
    (["--watch-poll", "1", "--watch-ckpt", "--ckpt-dir", "{tmp}/ck"],
     _check_watch),
    (["--watch-delay", "1", "--watch-ckpt", "--ckpt-dir", "{tmp}/ck"],
     _check_watch),
    (["--log-jsonl", "{tmp}/serve.jsonl"], _check_log_jsonl),
    (["--run-id", "abc"], _check_run_id),
    (["--dtype", "int8"], _check_int8),
    (["--serve-dtype", "int8"], _check_int8),
]


@pytest.mark.parametrize("flags,check", LIFTED_SERVE_FLAGS,
                         ids=[f[0] for f, _ in LIFTED_SERVE_FLAGS])
def test_lifted_serve_flags_parse_and_run_on_the_cpu(tmp_path, flags, check):
    flags = [f.format(tmp=tmp_path) for f in flags]
    args = cli.build_serve_parser().parse_args(SERVE_TINY + flags)
    server = cli.build_server(args)

    def run():
        if not server.listening:
            server.start()
        check(server, args)

    try:
        _within_limit(run, SERVE_LIMIT_S)
    finally:
        server.close()


def _train_ckpt(tmp_path, *flags, name="ck"):
    """A tiny run with ``--ckpt-dir tmp_path/name``; returns its state,
    history and the checkpoint directory."""
    directory = tmp_path / name
    args = cli.build_train_parser().parse_args(
        TINY_ARGV + ["--ckpt-dir", str(directory), *flags])
    state, history = cli.train(args)
    return state, history, directory


def _steps_on_disk(directory):
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.is_dir() and p.name.isdigit())


def _manifests(directory):
    return json.loads((directory / "manifests.json").read_text())


def _case_ckpt_every(tmp_path):
    _, _, d = _train_ckpt(tmp_path, "--steps", "4", "--ckpt-every", "3",
                          "--ckpt-keep-last", "0")
    assert _steps_on_disk(d) == [1, 3, 4]  # first save, cadence, the end


def _case_async_ckpt(tmp_path):
    _, _, sync = _train_ckpt(tmp_path, "--steps", "3", "--ckpt-every", "1",
                             name="sync")
    _, _, d = _train_ckpt(tmp_path, "--steps", "3", "--ckpt-every", "1",
                          "--async-ckpt")
    assert _steps_on_disk(d) == [1, 2, 3]
    assert _manifests(d) == _manifests(sync)  # the same bytes, written late


def _case_ckpt_keep_last(tmp_path):
    _, _, d = _train_ckpt(tmp_path, "--steps", "4", "--ckpt-every", "1",
                          "--ckpt-keep-last", "2")
    assert _steps_on_disk(d) == [3, 4]
    assert sorted(_manifests(d)) == ["3", "4"]


def _case_ckpt_keep_every(tmp_path):
    _, _, d = _train_ckpt(tmp_path, "--steps", "5", "--ckpt-every", "1",
                          "--ckpt-keep-last", "1", "--ckpt-keep-every", "2")
    assert _steps_on_disk(d) == [2, 4, 5]


def _case_restore_step(tmp_path):
    _train_ckpt(tmp_path, "--steps", "4", "--ckpt-every", "1",
                "--ckpt-keep-last", "0")
    state, history, d = _train_ckpt(tmp_path, "--steps", "3", "--ckpt-every",
                                    "1", "--ckpt-keep-last", "0",
                                    "--restore-step", "1")
    # resumed at 1, the steps after it deleted, the replay saved 2 and 3
    assert [h["step"] for h in history] == [2, 3] and state.step == 3
    assert _steps_on_disk(d) == [1, 2, 3]


def _case_ckpt_save_ef(tmp_path):
    from ntxent_tpu_torch.utils import msgpack

    _, _, d = _train_ckpt(tmp_path, "--ckpt-save-ef")
    tree = msgpack.from_bytes((d / "2" / "state.msgpack").read_bytes())
    assert tree["ef_residual"] is None  # the float32 wire keeps none


def _case_ckpt_mirror(tmp_path):
    mirror = tmp_path / "mirror"
    _, _, d = _train_ckpt(tmp_path, "--ckpt-mirror", str(mirror))
    assert _steps_on_disk(mirror) == _steps_on_disk(d) == [1, 2]
    assert _manifests(mirror) == _manifests(d)


def _case_no_ckpt_verify(tmp_path):
    _, _, d = _train_ckpt(tmp_path, "--no-ckpt-verify")
    assert _steps_on_disk(d) == [1, 2]
    assert not (d / "manifests.json").exists()


def _serve(tmp_path, *flags):
    args = cli.build_serve_parser().parse_args(
        ["--device", "cpu", "--model", "tiny", "--port", "0", "--image-size",
         "8", "--proj-hidden-dim", "16", "--proj-dim", "8", "--no-warmup",
         *flags])
    return cli.build_server(args)


def _case_serve_ckpt_dir(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        _serve(tmp_path, "--ckpt-dir", str(tmp_path / "empty"))
    state, _, d = _train_ckpt(tmp_path)
    server = _serve(tmp_path, "--ckpt-dir", str(d))
    want = state.model.state_dict()
    for name, value in server.engine.model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0)


def _case_serve_accum_steps(tmp_path):
    _, _, d = _train_ckpt(tmp_path)
    server = _serve(tmp_path, "--ckpt-dir", str(d), "--accum-steps", "2")
    out = server.engine.embed(np.zeros((2, 8, 8, 3), np.float32))
    assert out.shape == (2, 256) and np.isfinite(out).all()  # features


# The checkpoint flags each JAX parser takes, now ported: each case runs
# the flag and checks what it does.
CKPT_FLAG_CASES = {
    "train_--ckpt-every": _case_ckpt_every,
    "train_--async-ckpt": _case_async_ckpt,
    "train_--ckpt-keep-last": _case_ckpt_keep_last,
    "train_--ckpt-keep-every": _case_ckpt_keep_every,
    "train_--restore-step": _case_restore_step,
    "train_--ckpt-save-ef": _case_ckpt_save_ef,
    "train_--ckpt-mirror": _case_ckpt_mirror,
    "train_--no-ckpt-verify": _case_no_ckpt_verify,
    "serve_--ckpt-dir": _case_serve_ckpt_dir,
    "serve_--accum-steps": _case_serve_accum_steps,
}


@pytest.mark.parametrize("case", sorted(CKPT_FLAG_CASES))
def test_checkpoint_flags_do_their_job(case, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    CKPT_FLAG_CASES[case](tmp_path)


def _train(*flags):
    args = cli.build_train_parser().parse_args(TINY_ARGV + list(flags))
    return cli.train(args)


def _same_state(a, b):
    from ntxent_tpu_torch.weights import train_state_dict

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            elif v is not None:
                yield prefix + (k,), np.asarray(v)

    want = dict(flat(train_state_dict(a)))
    got = dict(flat(train_state_dict(b)))
    assert want.keys() == got.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))


def _case_prefetch(tmp_path):
    """--prefetch 2 trains bit for bit as the run without it, and reports
    the prefetched batches' fetch and transfer times."""
    plain, h0 = _train()
    ahead, h1 = _train("--prefetch", "2")
    _same_state(plain, ahead)
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]
    assert "fetch_ms" not in h0[0]
    assert h1[0]["fetch_ms"] >= 0 and h1[0]["transfer_ms"] >= 0


def _case_lag_metrics(tmp_path):
    """--lag-metrics reads each outcome a step late and ends bit for bit
    where the synchronous guard ends, a NaN batch skipped alike."""
    chaos = ["--nan-policy", "skip", "--chaos", "nan@1", "--steps", "3"]
    sync, _ = _train(*chaos)
    lag, history = _train(*chaos, "--lag-metrics")
    _same_state(sync, lag)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert lag.optimizer.count == 2


def _npy_store(tmp_path, rows=16, size=8):
    path = tmp_path / "rows.npy"
    np.save(path, np.random.default_rng(1).integers(
        0, 256, (rows, size, size, 3), dtype=np.uint8))
    return str(path)


def _case_dataset_npy(tmp_path):
    """--dataset npy trains on the store at its own size; another
    --image-size exits."""
    store = _npy_store(tmp_path, size=8)
    argv = [a for a in TINY_ARGV]
    argv[argv.index("--image-size") + 1] = "12"
    with pytest.raises(SystemExit, match="disagrees with the npy store"):
        cli.train(cli.build_train_parser().parse_args(
            argv + ["--dataset", "npy", "--data-dir", store]))
    args = cli.build_train_parser().parse_args(
        [a for a in argv if a not in ("--image-size", "12")]
        + ["--dataset", "npy", "--data-dir", store])
    state, history = cli.train(args)
    assert args.image_size == 8 and state.step == 2
    assert all(np.isfinite(h["loss"]) for h in history)


def _case_loader_native(tmp_path):
    """--loader native trains bit for bit as --loader python on the same
    store; a source that is not a memmap exits."""
    store = _npy_store(tmp_path)
    python, _ = _train("--dataset", "npy", "--data-dir", store)
    native, _ = _train("--dataset", "npy", "--data-dir", store, "--loader",
                       "native", "--prefetch", "2", "--lag-metrics")
    _same_state(python, native)
    with pytest.raises(SystemExit, match="--loader native: .*memmap"):
        _train("--loader", "native")  # synthetic arrays live in memory


def _case_dataset_cifar10(tmp_path):
    from test_torch_datasets import _write_cifar

    _write_cifar(tmp_path, np.random.default_rng(2), rows=2)
    state, history = _train("--dataset", "cifar10", "--data-dir",
                            str(tmp_path), "--image-size", "32")
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)
    with pytest.raises(SystemExit, match="requires --data-dir"):
        _train("--dataset", "cifar10")


def _case_dataset_imagefolder(tmp_path):
    from test_torch_datasets import _write_image_folder

    _write_image_folder(tmp_path, np.random.default_rng(3))
    state, history = _train("--dataset", "imagefolder", "--data-dir",
                            str(tmp_path))
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)


# The input pipeline's flags, ported from ROADMAP.md Queue A 7(b): each
# case runs the flag and checks what it does.
PIPELINE_FLAG_CASES = {
    "train_--prefetch_2": _case_prefetch,
    "train_--lag-metrics": _case_lag_metrics,
    "train_--dataset_npy": _case_dataset_npy,
    "train_--loader_native": _case_loader_native,
    "train_--dataset_cifar10": _case_dataset_cifar10,
    "train_--dataset_imagefolder": _case_dataset_imagefolder,
}


@pytest.mark.parametrize("case", sorted(PIPELINE_FLAG_CASES))
def test_pipeline_flags_do_their_job(case, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    PIPELINE_FLAG_CASES[case](tmp_path)


def test_restore_step_without_a_checkpoint_dir_exits():
    args = cli.build_train_parser().parse_args(TINY_ARGV + ["--restore-step",
                                                            "2"])
    with pytest.raises(SystemExit, match="--restore-step needs --ckpt-dir"):
        cli.train(args)


def test_every_flag_of_the_jax_parsers_parses_here():
    from ntxent_tpu import cli as jcli

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert options(jcli.build_parser()) <= options(
        cli.build_train_parser())
    assert options(jcli.build_serve_parser()) <= options(
        cli.build_serve_parser())
    assert options(jcli.build_eval_parser()) <= options(
        cli.build_eval_parser())
    # and at the JAX CLI's defaults nothing exits
    cli._check_train_args(cli.build_train_parser().parse_args(
        ["--device", "cpu"]))
    cli._check_serve_args(cli.build_serve_parser().parse_args([]))


@pytest.mark.parametrize("platform,device", [("cpu", "cpu"), ("gpu", "cuda"),
                                             ("cuda", "cuda")])
def test_platform_selects_the_device(platform, device):
    args = cli.build_train_parser().parse_args(["--platform", platform])
    cli._check_train_args(args)
    assert args.device == device
    args = cli.build_serve_parser().parse_args(["--platform", platform])
    cli._check_serve_args(args)
    assert args.device == device
    with pytest.raises(SystemExit, match="CUDA card"):
        cli._check_train_args(cli.build_train_parser().parse_args(
            ["--platform", "tpu"]))


def test_tiny_resnet_trains_with_the_platform_flag(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = [a for a in TINY_ARGV if a not in ("--device", "cpu")]
    args = cli.build_train_parser().parse_args(argv + ["--platform", "cpu"])
    _, history = cli.train(args)
    assert [h["step"] for h in history] == [1, 2]


# ---------------------------------------------------------------------------
# model parallelism and MoE (Queue A 9)
# ---------------------------------------------------------------------------

VIT_ARGV = ["--device", "cpu", "--model", "vit_t16", "--vit-attention",
            "flash", "--image-size", "16", "--batch", "4", "--steps", "2",
            "--log-every", "1", "--proj-hidden-dim", "16", "--proj-dim", "8",
            "--synthetic-samples", "8", "--warmup-steps", "1"]


@pytest.fixture
def world_of_one(tmp_path):
    import datetime

    from ntxent_tpu_torch.parallel import mesh

    mesh.init_from_file(tmp_path / "store", 0, 1, device="cpu",
                        timeout=datetime.timedelta(seconds=60))
    yield
    mesh.shutdown()


@pytest.mark.parametrize("argv,match", [
    (VIT_ARGV + ["--parallel", "tp", "--moe-experts", "2"],
     "does not collect the MoE aux loss"),
    (VIT_ARGV + ["--parallel", "tp", "--dcn-slices", "2"],
     "does not compose with --parallel tp"),
    (VIT_ARGV + ["--parallel", "tp", "--model-par", "3"],
     "--model-par 3 must divide 1 devices"),
    (TINY_ARGV + ["--fsdp", "--dcn-slices", "2"],
     "--dcn-slices 2 must divide the 1 devices"),
    (TINY_ARGV + ["--moe-experts", "2"], "requires a ViT model"),
], ids=["tp_moe", "tp_dcn", "model_par", "fsdp_dcn", "moe_resnet"])
def test_model_parallel_flags_exit_as_the_jax_cli(argv, match,
                                                  world_of_one):
    """The JAX CLI's exits (``cli.py:720-745``, ``:411-418``, ``:355``),
    in a world of one joined beforehand."""
    with pytest.raises(SystemExit, match=match):
        cli.train(cli.build_train_parser().parse_args(argv),
                  data_parallel=True)


@pytest.mark.parametrize("argv,branch", [
    (TINY_ARGV + ["--fsdp"], "FSDP (ZeRO-3) over 1 ranks"),
    (VIT_ARGV + ["--parallel", "tp", "--fsdp", "--tp-loss-axes", "both",
                  "--model-par", "1"],
     "Megatron + ZeRO-3 over the (1, 1) (data, model) grid"),
    (VIT_ARGV + ["--moe-experts", "2", "--fsdp"],
     "FSDP (ZeRO-3) over 1 ranks"),
], ids=["fsdp", "tp_fsdp", "fsdp_moe"])
def test_model_parallel_branches_train_save_and_resume(
        argv, branch, world_of_one, tmp_path, caplog):
    """Each branch trains in a world of one, saves its sharded state in
    the single-card format, and a longer run resumes it; the JAX CLI's
    warnings for what it ignores."""
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--nan-policy", "skip",
            "--collective-dtype", "bf16"]
    with caplog.at_level("INFO"):
        state, history = cli.train(cli.build_train_parser().parse_args(
            argv + ckpt), data_parallel=True)
    assert branch in caplog.text and state.sharding is not None
    assert "--nan-policy skip ignored" in caplog.text
    assert "--collective-dtype bf16 ignored" in caplog.text
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    if "--moe-experts" in argv:
        assert all(np.isfinite(h["moe_aux"]) for h in history)
    caplog.clear()
    with caplog.at_level("INFO"):
        _, history = cli.train(cli.build_train_parser().parse_args(
            argv + ckpt + ["--steps", "3"]), data_parallel=True)
    assert "resumed from checkpoint at step 2" in caplog.text
    assert [h["step"] for h in history] == [3]


def test_moe_losses_agree_through_both_clis(tmp_path, monkeypatch):
    """``--moe-experts 2`` through the JAX CLI and the port's on an npy
    store of black images (every view of a black image is black, so both
    CLIs see the same views): the JAX CLI's step 1 (at the warmup's lr of
    0, so its checkpoint holds the initial weights) and the port's step 2
    from that checkpoint compute the same loss, log(2B - 1) plus 0.01
    times the same aux; bf16 towers, 1e-3."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from ntxent_tpu_torch.resilience.crashsim import losses_from_jsonl

    repo = Path(__file__).resolve().parents[1]
    store = tmp_path / "black.npy"
    np.save(store, np.zeros((16, 16, 16, 3), np.uint8))
    flags = ["--model", "vit_t16", "--dataset", "npy", "--data-dir",
             str(store), "--batch", "8", "--moe-experts", "2",
             "--proj-hidden-dim", "16", "--proj-dim", "8", "--log-every",
             "1", "--warmup-steps", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(repo))
    env.pop("XLA_FLAGS", None)  # one CPU device: the JAX CLI's one card
    done = subprocess.run(
        [sys.executable, "-m", "ntxent_tpu.cli", "--platform", "cpu",
         *flags, "--steps", "1", "--ckpt-dir", str(tmp_path / "jax"),
         "--log-jsonl", str(tmp_path / "jax.jsonl")], cwd=str(repo),
        env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    _, history = cli.train(cli.build_train_parser().parse_args(
        ["--device", "cpu", *flags, "--steps", "2", "--ckpt-dir",
         str(tmp_path / "port")]))
    jax_loss = losses_from_jsonl(tmp_path / "jax.jsonl")[1]
    assert [h["step"] for h in history] == [2]
    np.testing.assert_allclose(history[0]["loss"], jax_loss, atol=1e-3)
    assert abs(jax_loss - np.log(15.0)) > 1e-4  # the aux is in both


def test_eval_takes_moe_checkpoints(tmp_path, monkeypatch, capsys):
    """``eval --moe-experts 2`` restores a MoE run's checkpoint (the MoE
    leaves in the flax layout) and reports its step."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ckpt = str(tmp_path / "ck")
    cli.train(cli.build_train_parser().parse_args(
        VIT_ARGV + ["--moe-experts", "2", "--ckpt-dir", ckpt]))
    assert cli.eval_main(["--device", "cpu", "--model", "vit_t16",
                          "--vit-attention", "flash", "--image-size", "16",
                          "--proj-hidden-dim", "16", "--proj-dim", "8",
                          "--moe-experts", "2", "--ckpt-dir", ckpt,
                          "--protocol", "knn", "--max-train", "32",
                          "--max-test", "16", "--batch", "16"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["step"] == 2 and 0.0 <= result["knn_top1"] <= 1.0
