"""Crash-replay audit, counterpart of ``ntxent_tpu/resilience/crashsim.py``:
SIGKILL a real training run of the port and prove the resume lossless.

1. run one uninterrupted **reference** training child to the end and
   fingerprint its final checkpoint (CRC32 of ``state.msgpack`` and of
   ``data_state.json``: the codec's bytes are deterministic, so equal
   files are equal parameters, optimizer state, step and data position);
2. launch the same run in a **crash** directory and kill it with the
   chaos plan's ``kill@K`` at a seeded random batch, the first
   ``midsave`` rounds with ``NTXENT_CKPT_SLOW_MS`` set so that the
   SIGKILL lands inside a checkpoint write (a staging directory is on
   disk at death);
3. after every kill, assert that no step is torn (every step directory
   complete and CRC-clean; abandoned ``.tmp-*`` staging directories are
   the only debris, which the next incarnation purges);
4. run a last incarnation to the end and assert that its final
   checkpoint is bit-identical to the reference's.

Each incarnation is ``python -m ntxent_tpu_torch.cli train`` as a child
process, with ``--ckpt-every 1 --ckpt-keep-last 0 --async-ckpt``: by
default on the card, one child at a time, at the single-card SimCLR
path's width (ResNet-50, 224 px, batch 256); ``--device cpu`` with the
model flags the caller gives (``--model tiny --image-size 8 --batch 8``
is the small case). ``python -m ntxent_tpu_torch.resilience.crashsim
--workdir DIR`` runs the audit. Not ported: the elastic audit across
device counts and the multi-process incarnations (ROADMAP.md Queue A
3(b) and 9), and the loss curves from ``--log-jsonl`` (Queue A 11(b)):
the audit compares the fingerprints.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import logging
import os
import random
import shutil
import signal
import subprocess
import sys
import time
import zlib
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["AuditReport", "CrashAudit", "CrashAuditError",
           "checkpoint_fingerprint", "parse_schedule",
           "scan_checkpoint_dir"]

_TMP_PREFIX = ".tmp-"
_STATE_FILE = "state.msgpack"
_DATA_STATE_FILE = "data_state.json"
_REPO = Path(__file__).resolve().parents[2]


class CrashAuditError(AssertionError):
    """An audit invariant failed (a torn step, an inexact resume)."""


def _crc32_file(path: Path, chunk: int = 1 << 20) -> int:
    value = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            value = zlib.crc32(block, value)
    return value


def _step_dirs(ckpt_dir: Path) -> dict[int, Path]:
    out: dict[int, Path] = {}
    if not ckpt_dir.is_dir():
        return out
    for p in ckpt_dir.iterdir():
        if p.is_dir() and not p.name.startswith(_TMP_PREFIX) \
                and p.name.isdigit():
            out[int(p.name)] = p
    return out


def checkpoint_fingerprint(ckpt_dir: Path, step: int) -> dict:
    """``{file: [size, crc32]}`` of one step's state and data-position
    files: two runs equal here are equal in every tensor, the step and
    the input pipeline's position."""
    step_dir = _step_dirs(Path(ckpt_dir)).get(int(step))
    if step_dir is None:
        raise CrashAuditError(f"no checkpoint for step {step} under "
                              f"{ckpt_dir}")
    fp = {}
    for name in (_STATE_FILE, _DATA_STATE_FILE):
        p = step_dir / name
        if p.exists():
            fp[name] = [p.stat().st_size, _crc32_file(p)]
    if _STATE_FILE not in fp:
        raise CrashAuditError(f"step {step} under {ckpt_dir} has no "
                              f"{_STATE_FILE}")
    return fp


def scan_checkpoint_dir(ckpt_dir: Path) -> dict:
    """Post-mortem scan: ``torn`` steps (incomplete, or not matching their
    manifest's CRC) and leftover ``tmp`` staging directories. Atomic
    writes make ``torn == []`` the invariant a kill at any instant keeps;
    ``tmp`` debris right after a kill proves it landed mid-save."""
    ckpt_dir = Path(ckpt_dir)
    torn: list[str] = []
    try:
        manifests = json.loads((ckpt_dir / "manifests.json").read_text())
    except (OSError, json.JSONDecodeError):
        manifests = {}
    for step, step_dir in sorted(_step_dirs(ckpt_dir).items()):
        if not (step_dir / _STATE_FILE).exists():
            torn.append(f"{step}: missing {_STATE_FILE}")
            continue
        recorded = manifests.get(str(step))
        if recorded is None:
            continue  # complete but killed before its manifest landed
        for rel, (size, crc) in recorded["files"].items():
            p = step_dir / rel
            if not p.exists() or p.stat().st_size != size \
                    or _crc32_file(p) != crc:
                torn.append(f"{step}: {rel} fails manifest check")
                break
    tmp = sorted(p.name for p in ckpt_dir.iterdir()
                 if p.is_dir() and p.name.startswith(_TMP_PREFIX)) \
        if ckpt_dir.is_dir() else []
    return {"torn": torn, "tmp": tmp}


def parse_schedule(spec: str) -> list[tuple[int, int]]:
    """Parse an elastic schedule, ``"8,4x2,8"`` -> ``[(8, 1), (4, 2), (8,
    1)]``: each entry a total device count, optionally ``xP`` over P
    processes. (The elastic audit that runs it is not ported.)"""
    out: list[tuple[int, int]] = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        dev, _, procs = item.partition("x")
        try:
            d = int(dev)
            p = int(procs) if procs else 1
        except ValueError:
            raise ValueError(
                f"bad schedule entry {item!r}: expected DEVICES or "
                f"DEVICESxPROCESSES, e.g. '8' or '4x2'") from None
        if d < 1 or p < 1 or d % p:
            raise ValueError(
                f"bad schedule entry {item!r}: devices must be a positive "
                f"multiple of processes (got {d} over {p})")
        out.append((d, p))
    if not out:
        raise ValueError(f"empty schedule {spec!r}")
    return out


@dataclasses.dataclass
class AuditReport:
    kills: int = 0
    midsave_kills: int = 0
    completed_early: int = 0
    bitexact_completions: int = 0
    rounds: list = dataclasses.field(default_factory=list)
    final_step: int | None = None
    bit_exact: bool = False
    reference_fingerprint: dict = dataclasses.field(default_factory=dict)
    survivor_fingerprint: dict = dataclasses.field(default_factory=dict)
    elapsed_s: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


class CrashAudit:
    """Drive the kill -> scan -> resume -> verify loop against the CLI.

    One audit is one reference run, ``kills`` killed incarnations (the
    first ``midsave`` throttled so the SIGKILL lands inside a checkpoint
    write) spread over ``lineages`` crash directories, and one clean
    last incarnation in each. ``model`` at ``image_size`` and ``batch``
    (``tiny`` adds the reference audit's small head); ``device="cuda"``
    trains on the card, ``"cpu"`` adds ``--device cpu``."""

    def __init__(self, workdir: str | Path, steps: int = 8,
                 seed: int = 0, batch: int = 256, image_size: int = 224,
                 timeout_s: float = 180.0, slow_save_ms: int = 400,
                 model: str = "resnet50", device: str = "cuda"):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.steps = int(steps)
        self.seed = int(seed)
        self.batch = int(batch)
        self.image_size = int(image_size)
        self.timeout_s = float(timeout_s)
        self.slow_save_ms = int(slow_save_ms)
        self.model = model
        self.device = device

    # -- one training incarnation ----------------------------------------
    def _cmd(self, ckpt_dir: Path, chaos: str | None) -> list[str]:
        cmd = [sys.executable, "-m", "ntxent_tpu_torch.cli", "train"]
        if self.device == "cpu":
            cmd += ["--device", "cpu"]
        cmd += ["--model", self.model, "--image-size", str(self.image_size),
                "--batch", str(self.batch)]
        if self.model == "tiny":
            cmd += ["--proj-hidden-dim", "16", "--proj-dim", "8"]
        cmd += ["--dataset", "synthetic",
                "--synthetic-samples", str(max(64, 2 * self.batch)),
                "--steps", str(self.steps), "--warmup-steps", "1",
                "--seed", str(self.seed), "--ckpt-dir", str(ckpt_dir),
                "--ckpt-every", "1",
                "--ckpt-keep-last", "0",  # the audit reads every step
                "--async-ckpt", "--log-every", "1"]
        if chaos:
            cmd += ["--chaos", chaos]
        return cmd

    def _env(self, slow_save: bool) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            filter(None, [str(_REPO), env.get("PYTHONPATH")]))
        if slow_save:
            env["NTXENT_CKPT_SLOW_MS"] = str(self.slow_save_ms)
        else:
            env.pop("NTXENT_CKPT_SLOW_MS", None)
        return env

    def _run(self, ckpt_dir: Path, chaos: str | None = None,
             slow_save: bool = False) -> tuple[int, str]:
        proc = subprocess.run(
            self._cmd(ckpt_dir, chaos), env=self._env(slow_save), cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=self.timeout_s)
        return proc.returncode, proc.stdout or ""

    # -- the audit --------------------------------------------------------
    def run_reference(self) -> dict:
        ref_dir = self.workdir / "ref"
        rc, out = self._run(ref_dir)
        if rc != 0:
            raise CrashAuditError(f"reference run failed rc={rc}:\n"
                                  f"{out[-2000:]}")
        return checkpoint_fingerprint(ref_dir, self.steps)

    def _finish_and_verify(self, crash_dir: Path, report: AuditReport,
                           reference_fp: dict) -> None:
        """Run the crash directory to the end (unless it is there) and hold
        its final checkpoint to the reference's CRCs."""
        if max(_step_dirs(crash_dir), default=0) < self.steps:
            rc, out = self._run(crash_dir)
            if rc != 0:
                raise CrashAuditError(f"survivor run failed rc={rc}:\n"
                                      f"{out[-2000:]}")
        scan = scan_checkpoint_dir(crash_dir)
        if scan["torn"] or scan["tmp"]:
            raise CrashAuditError(f"survivor left debris: {scan}")
        report.final_step = max(_step_dirs(crash_dir))
        if report.final_step != self.steps:
            raise CrashAuditError(f"survivor finished at step "
                                  f"{report.final_step}, wanted {self.steps}")
        report.survivor_fingerprint = checkpoint_fingerprint(crash_dir,
                                                             self.steps)
        if report.survivor_fingerprint != reference_fp:
            raise CrashAuditError(
                "survivor's final checkpoint differs from the uninterrupted "
                f"reference:\nref      = {reference_fp}\nsurvivor = "
                f"{report.survivor_fingerprint}")
        report.bitexact_completions += 1
        report.bit_exact = True

    def _run_lineage(self, name: str, kills: int, midsave: int,
                     rng: random.Random, ref_fp) -> AuditReport:
        """One kill -> scan -> resume lineage in its own crash directory;
        ``ref_fp()`` yields the reference fingerprint (a future)."""
        report = AuditReport()
        crash_dir = self.workdir / name
        round_no = 0
        while report.kills < kills or report.midsave_kills < midsave:
            round_no += 1
            if round_no > (kills + midsave) * 6:
                raise CrashAuditError(f"{name}: could not land {kills} kills "
                                      f"in {round_no} rounds")
            latest = max(_step_dirs(crash_dir), default=0)
            remaining = self.steps - latest
            if remaining < 3:
                # (nearly) done: start a fresh lifecycle for the full
                # range of kill points; the lineage's last lifecycle is
                # the one driven to a verified completion
                shutil.rmtree(crash_dir, ignore_errors=True)
                continue
            # k >= 2 leaves batch 1's step for a pending save to land
            k = rng.randint(2, remaining)
            slow = report.midsave_kills < midsave
            rc, out = self._run(crash_dir, chaos=f"kill@{k}", slow_save=slow)
            if rc == 0:
                # the run ended before the kill fired: a resume check
                report.completed_early += 1
                self._finish_and_verify(crash_dir, report, ref_fp())
                shutil.rmtree(crash_dir, ignore_errors=True)
                continue
            if rc not in (-signal.SIGKILL, 128 + signal.SIGKILL):
                raise CrashAuditError(f"{name} round {round_no}: expected "
                                      f"SIGKILL death, got rc={rc}:\n"
                                      f"{out[-2000:]}")
            scan = scan_checkpoint_dir(crash_dir)
            if scan["torn"]:
                raise CrashAuditError(f"{name} round {round_no}: torn "
                                      f"checkpoint step(s) after SIGKILL: "
                                      f"{scan['torn']}")
            mid = bool(scan["tmp"])
            report.kills += 1
            report.midsave_kills += int(mid)
            report.rounds.append({"lineage": name, "round": round_no,
                                  "kill_at": latest + k, "outcome": "killed",
                                  "midsave": mid, **scan})
            logger.info("%s round %d: kill@%d ok (midsave=%s, steps on "
                        "disk=%s)", name, round_no, latest + k, mid,
                        sorted(_step_dirs(crash_dir)))
        self._finish_and_verify(crash_dir, report, ref_fp())
        self._write_summary(f"summary_{name}.json", {
            "lineage": name, "mode": "kill", "kills": report.kills,
            "midsave_kills": report.midsave_kills,
            "restarts": report.kills + report.completed_early,
            "rounds": report.rounds, "final_step": report.final_step,
            "crc_exact": report.bit_exact,
            "verdict": "PASS:bitexact" if report.bit_exact
            else "FAIL:crc_mismatch"})
        return report

    def _write_summary(self, name: str, payload: dict) -> Path:
        path = self.workdir / name
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
        os.replace(tmp, path)
        return path

    def audit(self, kills: int = 5, midsave: int = 1, lineages: int = 2,
              workers: int | None = None) -> AuditReport:
        """The reference and ``lineages`` kill lineages, ``workers`` children
        at a time (default: one on the card, which holds one full-width
        run's memory: the reference first, then the lineages one after
        another; all at once on the CPU). The mid-save quota rides
        lineage 0."""
        t0 = time.monotonic()
        lineages = max(1, min(int(lineages), kills))
        quotas = [kills // lineages] * lineages
        for i in range(kills % lineages):
            quotas[i] += 1
        if workers is None:
            workers = 1 if self.device == "cuda" else lineages + 1
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            ref_future = pool.submit(self.run_reference)
            futures = [pool.submit(self._run_lineage, f"crash{i}", quotas[i],
                                   midsave if i == 0 else 0,
                                   random.Random(self.seed * 1000 + i),
                                   ref_future.result)
                       for i in range(lineages)]
            reports = [f.result() for f in futures]
            reference_fp = ref_future.result()

        report = AuditReport(reference_fingerprint=reference_fp)
        for sub in reports:
            report.kills += sub.kills
            report.midsave_kills += sub.midsave_kills
            report.completed_early += sub.completed_early
            report.bitexact_completions += sub.bitexact_completions
            report.rounds.extend(sub.rounds)
            report.final_step = sub.final_step
            report.survivor_fingerprint = sub.survivor_fingerprint
        report.bit_exact = all(sub.bit_exact for sub in reports)
        if report.midsave_kills < midsave:
            raise CrashAuditError(f"only {report.midsave_kills}/{midsave} "
                                  "kills landed mid-save (no staging "
                                  "directory at death)")
        report.elapsed_s = round(time.monotonic() - t0, 2)
        self._write_summary("audit_summary.json", {
            "mode": "kill", "kills": report.kills,
            "midsave_kills": report.midsave_kills,
            "restarts": report.kills + report.completed_early,
            "final_step": report.final_step, "crc_exact": report.bit_exact,
            "reference_fingerprint": report.reference_fingerprint,
            "survivor_fingerprint": report.survivor_fingerprint,
            "elapsed_s": report.elapsed_s,
            "verdict": "PASS:bitexact" if report.bit_exact
            else "FAIL:crc_mismatch"})
        return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Crash-replay audit: SIGKILL the port's training at "
                    "seeded random batches (one at least inside a "
                    "checkpoint write) and prove a bit-exact resume.")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--kills", type=int, default=5)
    parser.add_argument("--midsave", type=int, default=1)
    parser.add_argument("--lineages", type=int, default=2)
    parser.add_argument("--workers", type=int, default=None,
                        help="children at a time (default: 1 on the card, "
                             "every lineage and the reference at once on "
                             "the CPU)")
    parser.add_argument("--model", default="resnet50")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                        help="cuda (default; the children fail without a "
                             "GPU) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--timeout-s", type=float, default=180.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(message)s")
    audit = CrashAudit(args.workdir, steps=args.steps, seed=args.seed,
                       batch=args.batch, image_size=args.image_size,
                       timeout_s=args.timeout_s, model=args.model,
                       device=args.device)
    try:
        report = audit.audit(kills=args.kills, midsave=args.midsave,
                             lineages=args.lineages, workers=args.workers)
    except CrashAuditError as e:
        print(f"CRASH AUDIT FAILED: {e}", file=sys.stderr)
        return 1
    print(report.to_json())
    print(f"crash audit: OK, {report.kills} kills ({report.midsave_kills} "
          f"mid-save), resume bit-exact at step {report.final_step} in "
          f"{report.elapsed_s}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
