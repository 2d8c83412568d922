"""CLI end-to-end: count -> stats -> query -> resume."""

import collections
import random
import sys

import pytest

from kmers_tpu.__main__ import main
from kmers_tpu.oracle import numpy_ref as o

RNG = random.Random(22)


@pytest.fixture()
def fasta(tmp_path):
    recs = ["".join(RNG.choice("ACGT") for _ in range(90)) for _ in range(20)]
    p = tmp_path / "reads.fasta"
    with open(p, "w") as f:
        for i, r in enumerate(recs):
            f.write(f">r{i}\n{r}\n")
    return str(p), recs


def test_cli_count_query_stats(fasta, tmp_path, capsys):
    path, recs = fasta
    out = str(tmp_path / "t.npz")
    assert main(["count", path, "-k", "15", "-o", out,
                 "--batch", "8", "--length", "96"]) == 0
    # stats
    assert main(["stats", out]) == 0
    stats = capsys.readouterr().out
    want = collections.Counter()
    for r in recs:
        for p in range(len(r) - 15 + 1):
            fw = o.word_from_bytes(r[p:p + 15].encode())
            want[min(fw, o.reverse_complement_word(fw, 15))] += 1
    assert f"total kmers:    {sum(want.values())}" in stats
    # query: most frequent + absent
    top, top_c = want.most_common(1)[0]
    top_s = o.word_to_string(top, 15).upper()
    assert main(["query", out, top_s, "A" * 15]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert lines[0] == f"{top_s}\t{top_c}"
    # bad query length
    assert main(["query", out, "ACGT"]) == 2


def test_cli_eviction_surfaced_in_warning_and_stats(fasta, tmp_path,
                                                    capsys):
    """VERDICT r4 item 10: when capacity < distinct keys, the eviction is
    never silent -- count exits 3 with a capacity WARNING, and `stats`
    surfaces the dropped mass (the exactness contract's observable)."""
    path, recs = fasta
    out = str(tmp_path / "small.npz")
    rc = main(["count", path, "-k", "15", "-o", out,
               "--batch", "8", "--length", "96", "--capacity", "64",
               "--merge-every", "1"])
    assert rc == 3
    err = capsys.readouterr().err
    assert "capacity exceeded" in err and "--capacity" in err
    assert main(["stats", out]) == 0
    stats = capsys.readouterr().out
    import re

    m = re.search(r"dropped:\s+(\d+) distinct / (\d+) occurrences", stats)
    assert m, stats
    assert int(m.group(1)) > 0 and int(m.group(2)) > 0
    # surviving counts are lower bounds: live + dropped == emitted mass
    total = sum(len(r) - 15 + 1 for r in recs)
    m2 = re.search(r"total kmers:\s+(\d+)", stats)
    assert int(m2.group(1)) == total


def test_cli_help_states_exactness_contract(capsys):
    with pytest.raises(SystemExit) as e:
        main(["count", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "exactness contract" in out
    assert "environment knobs" not in out      # no tuning knobs left
    assert "lower bounds" in out


def test_cli_resume_k_mismatch(fasta, tmp_path):
    path, _ = fasta
    out = str(tmp_path / "t.npz")
    assert main(["count", path, "-k", "15", "-o", out]) == 0
    assert main(["count", path, "-k", "17", "-o", out, "--resume"]) == 2


def test_cli_crash_autorestart_failure_injection(fasta, tmp_path,
                                                 monkeypatch):
    """Elastic recovery (SURVEY.md §5.3): a transient mid-run fault
    (update() raises once) is detected, a checkpoint auto-saves, and the
    run restarts in-process and completes with the exact uncrashed table
    -- no human re-invocation."""
    from kmers_tpu.parallel.stream import StreamingCounter

    path, _recs = fasta
    clean_out = str(tmp_path / "clean.npz")
    crash_out = str(tmp_path / "crash.npz")
    args = ["-k", "15", "--batch", "4", "--length", "96",
            "--checkpoint-every", "1", "--capacity", "4096"]
    assert main(["count", path, "-o", clean_out] + args) == 0

    calls = {"n": 0}
    # _absorb is shared by update and update_packed, so the fault fires on
    # both the ASCII and the (default) packed ingest path
    real_absorb = StreamingCounter._absorb

    def flaky_absorb(self, res):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected fault: host died mid-run")
        return real_absorb(self, res)

    monkeypatch.setattr(StreamingCounter, "_absorb", flaky_absorb)
    assert main(["count", path, "-o", crash_out] + args) == 0
    assert calls["n"] > 3, "the restarted stream never resumed counting"

    import numpy as np

    a, b = np.load(clean_out), np.load(crash_out)
    for key in ("keys_hi", "keys_lo", "counts", "n_unique", "kmers"):
        np.testing.assert_array_equal(a[key], b[key])


def test_cli_persistent_fault_saves_and_exits(fasta, tmp_path, monkeypatch):
    """A fault that survives every restart exhausts --max-restarts, leaves
    a durable checkpoint of the completed batches, and exits 4; a later
    --resume run finishes with the exact table."""
    from kmers_tpu.parallel.stream import StreamingCounter

    path, _recs = fasta
    clean_out = str(tmp_path / "clean.npz")
    crash_out = str(tmp_path / "crash.npz")
    args = ["-k", "15", "--batch", "4", "--length", "96",
            "--checkpoint-every", "1", "--capacity", "4096"]
    assert main(["count", path, "-o", clean_out] + args) == 0

    real_absorb = StreamingCounter._absorb

    def dying_absorb(self, res):
        if self.batches >= 2:
            raise RuntimeError("injected persistent fault")
        return real_absorb(self, res)

    monkeypatch.setattr(StreamingCounter, "_absorb", dying_absorb)
    assert main(["count", path, "-o", crash_out, "--max-restarts", "1"]
                + args) == 4
    monkeypatch.setattr(StreamingCounter, "_absorb", real_absorb)
    assert main(["count", path, "-o", crash_out, "--resume"] + args) == 0

    import numpy as np

    a, b = np.load(clean_out), np.load(crash_out)
    for key in ("keys_hi", "keys_lo", "counts", "n_unique", "kmers"):
        np.testing.assert_array_equal(a[key], b[key])


def test_cli_sigkill_resume(fasta, tmp_path):
    """Kill-and-resume (VERDICT r2 item 7b): SIGKILL the counting process
    mid-run (no chance to trap anything), then --resume from the periodic
    checkpoint; the final table is byte-identical to an uninterrupted run."""
    import os
    import signal
    import subprocess
    import time

    import numpy as np

    path, _recs = fasta
    clean_out = str(tmp_path / "clean.npz")
    kill_out = str(tmp_path / "killed.npz")
    args = ["-k", "15", "--batch", "2", "--length", "96",
            "--checkpoint-every", "1", "--capacity", "4096"]
    assert main(["count", path, "-o", clean_out] + args) == 0

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # slow the stream enough that the kill lands mid-run: a tiny sitecustomize
    # injects a delay into every _absorb call of the child only
    hook_dir = tmp_path / "hook"
    hook_dir.mkdir()
    (hook_dir / "sitecustomize.py").write_text(
        "import time\n"
        "import kmers_tpu.parallel.stream as s\n"
        "_real = s.StreamingCounter._absorb\n"
        "def slow(self, res):\n"
        "    time.sleep(0.4)\n"
        "    return _real(self, res)\n"
        "s.StreamingCounter._absorb = slow\n")
    env["PYTHONPATH"] = f"{hook_dir}{os.pathsep}" + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmers_tpu", "count", path, "-o", kill_out]
        + args, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        ckpt = kill_out if os.path.exists(kill_out) else kill_out + ".npz"
        while time.time() < deadline:
            if os.path.exists(kill_out) or os.path.exists(ckpt):
                break
            if proc.poll() is not None:
                pytest.fail("child exited before writing any checkpoint")
            time.sleep(0.05)
        else:
            pytest.fail("no checkpoint appeared within 120s")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL

    saved = np.load(kill_out)
    assert 0 < int(saved["batches"]) <= 10   # genuinely partial
    assert main(["count", path, "-o", kill_out, "--resume"] + args) == 0

    a, b = np.load(clean_out), np.load(kill_out)
    for key in ("keys_hi", "keys_lo", "counts", "n_unique", "kmers"):
        np.testing.assert_array_equal(a[key], b[key])


def test_cli_sharded_count_matches_single(fasta, tmp_path):
    """--devices 8: CPU-mesh sharded end-to-end count of a FASTA file is
    bit-exact vs the single-device table (VERDICT r2 item 4)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    path, _recs = fasta
    out1 = str(tmp_path / "single.npz")
    out8 = str(tmp_path / "sharded.npz")
    args = ["-k", "15", "--batch", "8", "--length", "96",
            "--capacity", "4096"]
    assert main(["count", path, "-o", out1] + args) == 0
    assert main(["count", path, "-o", out8, "--devices", "8",
                 "--route-capacity", "512"] + args) == 0

    import numpy as np

    a, b = np.load(out1), np.load(out8)
    for key in ("keys_hi", "keys_lo", "counts", "n_unique", "kmers"):
        np.testing.assert_array_equal(a[key], b[key])
