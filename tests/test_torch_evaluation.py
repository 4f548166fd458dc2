"""The port's evaluation (``training/evaluation.py``, ``cli eval``) against
the JAX package's (``ntxent_tpu/training/evaluation.py``,
``ntxent_tpu.cli.eval_main``), on the CPU at small sizes.

Tolerances: the linear probe and fine-tuning fed the JAX draws (the
probe's initial weights; the fine-tuning head and minibatch indices)
end within 1e-4 of the JAX final loss, and their accuracies within one
row of the JAX ones (a near-tie may flip one argmax). kNN takes the same
features, so its accuracy is equal, save one row on a near-tie. At the
CLI, where the port draws its own initial weights from a
``torch.Generator``, the kNN accuracy is the JAX one within one row and
the probe's within 0.1; zero-shot is deterministic and equal within one
row.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu import cli as jcli
from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.training import evaluation as jeval
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.training import evaluation as teval
from test_torch_resnet import tiny_simclr_pair

torch.set_num_threads(1)  # one torch thread a test worker


def _features(n_train=96, n_test=40, dim=12, classes=4, seed=0):
    """Features with a class-dependent mean, and their labels."""
    rng = np.random.default_rng(seed)
    ytr = rng.integers(0, classes, n_train).astype(np.int32)
    yte = rng.integers(0, classes, n_test).astype(np.int32)
    centres = rng.normal(size=(classes, dim))
    ftr = (centres[ytr] + rng.normal(size=(n_train, dim))).astype(np.float32)
    fte = (centres[yte] + rng.normal(size=(n_test, dim))).astype(np.float32)
    return ftr, ytr, fte, yte


def test_linear_probe_with_the_jax_init_follows_jax():
    ftr, ytr, fte, yte = _features()
    key = jax.random.PRNGKey(3)
    want = jeval.linear_probe(jnp.asarray(ftr), jnp.asarray(ytr),
                              jnp.asarray(fte), jnp.asarray(yte), 4,
                              steps=60, key=key)
    w0 = np.asarray(jax.random.normal(key, (12, 4))) * 0.01
    got = teval.linear_probe(torch.from_numpy(ftr), ytr,
                             torch.from_numpy(fte), yte, 4, steps=60,
                             init=(w0, np.zeros(4, np.float32)))
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    assert abs(got["train_accuracy"] - want["train_accuracy"]) <= 1 / 96
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 1 / 40


def test_linear_probe_draws_from_its_generator():
    ftr, ytr, fte, yte = _features(seed=1)
    runs = [teval.linear_probe(torch.from_numpy(ftr), ytr,
                               torch.from_numpy(fte), yte, 4, steps=20,
                               generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert runs[0] == runs[1] and runs[0]["final_loss"] != runs[2][
        "final_loss"]


@pytest.mark.parametrize("k", [1, 5, 200])
@pytest.mark.parametrize("ties", [False, True])
def test_knn_accuracy_equals_jax_on_the_same_features(k, ties):
    ftr, ytr, fte, yte = _features(seed=2)
    if ties:  # rows that repeat: equal similarities, ordered by index
        ftr = np.repeat(ftr[:8], 12, axis=0)
    want = jeval.knn_accuracy(jnp.asarray(ftr), jnp.asarray(ytr),
                              jnp.asarray(fte), jnp.asarray(yte), k=k)
    got = teval.knn_accuracy(torch.from_numpy(ftr), ytr,
                             torch.from_numpy(fte), yte, k=k)
    # k = 200 is clamped to the 96 train rows, as in JAX
    assert abs(got - want) <= 1 / 40


def test_extract_features_pads_the_tail_to_one_shape():
    images = torch.arange(7 * 2, dtype=torch.float32).reshape(7, 2)
    shapes = []

    def apply(x):
        shapes.append(tuple(x.shape))
        return x * 2

    out = teval.extract_features(apply, images, batch_size=3)
    assert shapes == [(3, 2)] * 3
    assert torch.equal(out, images * 2)
    want = jeval.extract_features(lambda x: x * 2, jnp.asarray(
        images.numpy()), batch_size=3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _tiny_images(n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n).astype(np.int32)
    images = (rng.uniform(size=(n, 8, 8, 3)) * 0.5
              + labels[:, None, None, None] * 0.2).astype(np.float32)
    return images, labels


def test_finetune_with_the_jax_init_and_indices_follows_jax():
    jmodel, variables, model = tiny_simclr_pair(seed=4)
    xtr, ytr = _tiny_images(24, 5)
    xte, yte = _tiny_images(10, 6)
    key = jax.random.PRNGKey(7)
    steps, batch = 4, 8
    want = jeval.finetune(jmodel, variables, jnp.asarray(xtr),
                          jnp.asarray(ytr), jnp.asarray(xte),
                          jnp.asarray(yte), 3, steps=steps,
                          batch_size=batch, learning_rate=1e-3, key=key)
    k_head, k_idx = jax.random.split(key)
    feat_dim = int(model.features(torch.from_numpy(xtr[:1])).shape[-1])
    head = np.asarray(jax.random.normal(k_head, (feat_dim, 3))) * 0.01
    idx = np.asarray(jax.random.randint(k_idx, (steps, batch), 0, 24))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = teval.finetune(model, xtr, ytr, xte, yte, 3, steps=steps,
                         batch_size=batch, learning_rate=1e-3,
                         init=(head, np.zeros(3, np.float32)), indices=idx)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    assert abs(got["train_accuracy"] - want["train_accuracy"]) <= 1 / 24
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 1 / 10
    # the caller's model is left as it was
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_finetune_decays_the_kernels_alone():
    _, _, model = tiny_simclr_pair()
    decays = teval._decays(model)
    assert any(decays.values()) and not all(decays.values())
    from ntxent_tpu_torch.weights import flax_paths

    for name, path in flax_paths(model).items():
        assert decays[name] == (path[-1] == "kernel")


# ---------------------------------------------------------------------------
# ntxent-eval
# ---------------------------------------------------------------------------

EVAL_MODEL = ["--model", "tiny", "--image-size", "8", "--proj-hidden-dim",
              "16", "--proj-dim", "8"]


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny SimCLR step written by the JAX package's manager."""
    directory = tmp_path_factory.mktemp("jax_ckpt")
    encoder = jcli._make_encoder("tiny", 8)
    jmodel = JaxSimCLR(encoder=encoder, proj_hidden_dim=16, proj_dim=8)
    jstate = jax_state(jmodel, jax.random.PRNGKey(5), (1, 8, 8, 3),
                       JaxConfig())
    rng = np.random.default_rng(6)
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, np.shape(x)),
                              jnp.float32), jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats, step=jnp.asarray(3))
    manager = JaxManager(directory)
    assert manager.save(3, jstate, force=True)
    manager.close()
    return directory


def _json(capsys, fn, argv):
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_of_a_jax_checkpoint_reports_the_jax_accuracies(
        jax_checkpoint, capsys):
    argv = EVAL_MODEL + ["--ckpt-dir", str(jax_checkpoint), "--protocol",
                         "both", "--probe-steps", "60", "--k", "10"]
    want = _json(capsys, jcli.eval_main, argv + ["--platform", "cpu"])
    got = _json(capsys, cli.main, ["eval", "--device", "cpu", *argv])
    assert got["step"] == want["step"] == 3
    assert abs(got["knn_top1"] - want["knn_top1"]) <= 1 / 128
    assert abs(got["probe_top1"] - want["probe_top1"]) <= 0.1
    jax.clear_caches()


def test_eval_finetune_of_a_jax_checkpoint(jax_checkpoint, capsys):
    argv = EVAL_MODEL + ["--ckpt-dir", str(jax_checkpoint), "--protocol",
                         "finetune", "--finetune-steps", "3",
                         "--finetune-batch", "16", "--max-train", "64",
                         "--max-test", "32"]
    got = _json(capsys, cli.eval_main, ["--device", "cpu", *argv])
    assert got["step"] == 3 and np.isfinite(got["finetune_loss"])
    assert 0.0 <= got["finetune_top1"] <= 1.0
    assert 0.0 <= got["finetune_train_top1"] <= 1.0


@pytest.mark.parametrize("dataset", ["synthetic", "cifar10", "imagefolder"])
def test_labeled_arrays_are_the_jax_ones(dataset, tmp_path):
    from test_torch_datasets import _write_cifar, _write_image_folder

    argv = ["--ckpt-dir", "x", "--dataset", dataset, "--image-size", "8",
            "--max-train", "5", "--max-test", "3", "--seed", "2"]
    if dataset == "cifar10":
        _write_cifar(tmp_path, np.random.default_rng(0))
        argv = argv[:-6] + ["--data-dir", str(tmp_path), "--image-size",
                            "32", "--max-train", "5", "--max-test", "3",
                            "--seed", "2"]
    elif dataset == "imagefolder":
        _write_image_folder(tmp_path, np.random.default_rng(0))
        argv += ["--data-dir", str(tmp_path)]
    got = cli._labeled_arrays(cli.build_eval_parser().parse_args(argv))
    want = jcli._labeled_arrays(jcli.build_eval_parser().parse_args(argv))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got = cli._labeled_arrays(cli.build_eval_parser().parse_args(argv),
                              test_only=True)
    want = jcli._labeled_arrays(jcli.build_eval_parser().parse_args(argv),
                                test_only=True)
    for a, b in zip(got, want):  # no train split read, but synthetic's
        np.testing.assert_array_equal(a, b)
    assert (got[0].shape[0] == 0) == (dataset != "synthetic")


def _clip_checkpoint(tmp_path):
    directory = tmp_path / "clip"
    argv = ["--objective", "clip", "--model", "tiny", "--device", "cpu",
            "--image-size", "16", "--token-len", "6", "--vocab-size", "50",
            "--batch", "8", "--steps", "2", "--synthetic-samples", "16",
            "--ckpt-dir", str(directory)]
    cli.train(cli.build_train_parser().parse_args(argv))
    tokens = np.random.default_rng(3).integers(0, 50, (4, 6))
    np.save(tmp_path / "prompts.npy", tokens)
    return directory, tmp_path / "prompts.npy"


def test_zeroshot_on_a_tiny_clip_checkpoint_equals_jax(tmp_path, capsys):
    directory, prompts = _clip_checkpoint(tmp_path)
    argv = ["--objective", "clip", "--model", "tiny", "--image-size", "16",
            "--token-len", "6", "--vocab-size", "50", "--ckpt-dir",
            str(directory), "--protocol", "zeroshot", "--class-tokens",
            str(prompts)]
    capsys.readouterr()
    got = _json(capsys, cli.eval_main, ["--device", "cpu", *argv])
    want = _json(capsys, jcli.eval_main, argv + ["--platform", "cpu"])
    assert got["step"] == want["step"] == 2
    assert (got["num_classes"], got["num_test"]) == (4, 128)
    assert abs(got["zeroshot_top1"] - want["zeroshot_top1"]) <= 1 / 128
    jax.clear_caches()


def _evaluates_with_the_stem(tmp_path, capsys):
    """A ResNet-18 checkpoint at 72 px (the ImageNet stem) evaluated with
    ``--stem space_to_depth`` and with the conv stem it was written with:
    the checkpoints interchange (one weight), and the kNN accuracies agree
    within one row of the 32 (bf16 rounding may flip a near-tie)."""
    from ntxent_tpu_torch.training import CheckpointManager
    from ntxent_tpu_torch.training import trainer as ttrain

    model = ["--model", "resnet18", "--image-size", "72",
             "--proj-hidden-dim", "16", "--proj-dim", "8"]
    args = cli.build_train_parser().parse_args(["--device", "cpu", *model])
    state = ttrain.create_train_state(cli.build_model(args),
                                      ttrain.TrainerConfig(),
                                      torch.device("cpu"))
    state.step = 1
    CheckpointManager(tmp_path).save(1, state)
    base = ["eval", "--device", "cpu", *model, "--ckpt-dir", str(tmp_path),
            "--protocol", "knn", "--k", "5", "--max-train", "32",
            "--max-test", "32", "--batch", "32"]
    got = {stem: _json(capsys, cli.main, base + ["--stem", stem])
           for stem in ("space_to_depth", "conv")}
    assert got["space_to_depth"]["step"] == got["conv"]["step"] == 1
    assert abs(got["space_to_depth"]["knn_top1"]
               - got["conv"]["knn_top1"]) <= 1 / 32


@pytest.mark.parametrize("flags,code_or_match", [
    (["--protocol", "finetune", "--objective", "clip"], 2),
    (["--protocol", "zeroshot"], 2),
    (["--protocol", "zeroshot", "--objective", "clip"], 2),
    (["--dataset", "npy"], "has no labels"),
    (["--stem", "space_to_depth"], r"ROADMAP.md Queue A 6\(b\)"),
    # ported since Queue A 9: the JAX CLI's refusal of a ResNet MoE
    (["--moe-experts", "2"], "requires a ViT model"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_eval_refusals(jax_checkpoint, flags, code_or_match, tmp_path,
                       capsys):
    """The JAX CLI's refusals; ``--stem space_to_depth`` (ROADMAP.md Queue
    A 6(b), ported since) evaluates instead (``_evaluates_with_the_stem``).
    """
    if flags[0] == "--stem":
        _evaluates_with_the_stem(tmp_path, capsys)
        return
    argv = ["--device", "cpu", *EVAL_MODEL, "--ckpt-dir",
            str(jax_checkpoint), *flags]
    if isinstance(code_or_match, int):
        assert cli.eval_main(argv) == code_or_match
        return
    with pytest.raises(SystemExit, match=code_or_match):
        cli.eval_main(argv)


def test_eval_without_a_checkpoint_or_a_gpu_exits(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        cli.eval_main(["--device", "cpu", *EVAL_MODEL, "--ckpt-dir",
                       str(tmp_path / "none")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.eval_main([*EVAL_MODEL, "--ckpt-dir", str(tmp_path)])
