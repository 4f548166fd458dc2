"""``ntxent-train`` of the port for ResNet SimCLR and its data-parallel
flags, on the CPU (the run of a gloo world of 2 is in
``test_torch_distributed.py``)."""

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


@pytest.mark.parametrize("flags,match", [
    (["--dp-loss", "chunked"], r"Queue A 3\(d\)"),
    (["--stem", "space_to_depth"], r"Queue A 6\(b\)"),
    (["--collective-dtype", "bf16"], r"Queue A 3\(e\)"),
    (["--parallel", "tp"], "Queue A 9"),
    (["--fsdp"], "Queue A 9"),
], ids=lambda f: "_".join(f) if isinstance(f, list) else None)
def test_unported_data_parallel_flags_exit_naming_their_item(flags, match):
    args = cli.build_train_parser().parse_args(TINY_ARGV + flags)
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
    """The strip and (since the pair slice) the pair schedules resolve;
    chunked raises naming its item, an unknown name as unknown."""
    from ntxent_tpu_torch.parallel import dist_loss, pair

    assert dist_loss.resolve_local_ntxent("strip") is \
        dist_loss.local_ntxent_allgather
    if error is None:
        assert dist_loss.resolve_local_ntxent(impl) is pair.pair_body
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


# Every flag the JAX CLI's parsers take and the port does not run yet, set
# to a value other than the JAX default, with the ROADMAP.md item its exit
# names.
TRAIN_FLAGS = [
    (["--ckpt-every", "100"], "Queue A 7"),
    (["--async-ckpt"], "Queue A 7"),
    (["--ckpt-keep-last", "5"], "Queue A 7"),
    (["--ckpt-keep-every", "10"], "Queue A 7"),
    (["--restore-step", "4"], "Queue A 7"),
    (["--ckpt-save-ef"], "Queue A 7"),
    (["--ckpt-mirror", "mirror"], "Queue A 7"),
    (["--no-ckpt-verify"], "Queue A 7"),
    (["--chaos", "nan@3"], "Queue A 7"),
    (["--stall-timeout", "30"], "Queue A 7"),
    (["--prefetch", "2"], r"Queue A 7\(b\)"),
    (["--lag-metrics"], r"Queue A 7\(b\)"),
    (["--ring-chunks", "4"], r"Queue A 3\(d\)"),
    (["--measure-overlap"], r"Queue A 3\(d\)"),
    (["--model-par", "4"], "Queue A 9"),
    (["--tp-loss-axes", "both"], "Queue A 9"),
    (["--moe-aux-weight", "0.05"], "Queue A 9"),
    (["--coordinator", "host:1234"], "Queue A 9"),
    (["--num-processes", "2"], "Queue A 9"),
    (["--process-id", "1"], "Queue A 9"),
    (["--dcn-slices", "2"], "Queue A 9"),
    (["--metrics-port", "0"], "Queue A 11"),
    (["--log-jsonl", "run.jsonl"], "Queue A 11"),
    (["--trace-dir", "traces"], "Queue A 11"),
    (["--trace-steps", "3"], "Queue A 11"),
    (["--slow-step-factor", "2"], "Queue A 11"),
]
SERVE_FLAGS = [
    (["--ckpt-dir", "ckpt"], r"Queue A 7\(a\)"),
    (["--accum-steps", "2"], r"Queue A 7\(a\)"),
    (["--stem", "space_to_depth", "--image-size", "224"],
     r"Queue A 6\(b\)"),
    (["--adaptive-buckets"], r"Queue A 8\(e\)"),
    (["--ladder-max-buckets", "4"], r"Queue A 8\(e\)"),
    (["--ladder-min-requests", "30"], r"Queue A 8\(e\)"),
    (["--ladder-interval", "0.5"], r"Queue A 8\(e\)"),
    (["--max-restarts", "2"], r"Queue A 8\(c\)"),
    (["--stall-timeout", "5"], r"Queue A 8\(c\)"),
    (["--port-file", "port"], r"Queue A 8\(c\)"),
    (["--watch-ckpt"], r"Queue A 8\(c\)"),
    (["--watch-poll", "1"], r"Queue A 8\(c\)"),
    (["--watch-delay", "1"], r"Queue A 8\(c\)"),
    (["--log-jsonl", "serve.jsonl"], r"Queue A 8\(f\)"),
    (["--run-id", "abc"], r"Queue A 8\(f\)"),
    (["--dtype", "int8"], r"Queue A 8\(d\)"),
    (["--serve-dtype", "int8"], r"Queue A 8\(d\)"),
]


@pytest.mark.parametrize(
    "command,flags,match",
    [("train", f, m) for f, m in TRAIN_FLAGS]
    + [("serve", f, m) for f, m in SERVE_FLAGS],
    ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_reference_flags_parse_and_exit_naming_their_item(command, flags,
                                                          match):
    """Each flag parses (no "unrecognized arguments" or "invalid choice")
    and, set, exits naming its ROADMAP.md item before any work."""
    if command == "train":
        args = cli.build_train_parser().parse_args(TINY_ARGV + flags)
        run = cli.train
    else:
        args = cli.build_serve_parser().parse_args(
            ["--device", "cpu", "--model", "tiny", "--port", "0"] + flags)
        run = cli.build_server
    with pytest.raises(SystemExit, match=f"ROADMAP.md {match}"):
        run(args)


def test_every_flag_of_the_jax_parsers_parses_here():
    from ntxent_tpu import cli as jcli

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert options(jcli.build_parser()) <= options(
        cli.build_train_parser())
    assert options(jcli.build_serve_parser()) <= options(
        cli.build_serve_parser())
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
