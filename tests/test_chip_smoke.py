"""chip_smoke.py without a GPU: it must refuse to run and print no result,
and its phases -- the same code the GPU runs -- must pass on the CPU at a
tiny size (the rehearsal before a chip call)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, *args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (json.JSONDecodeError, AttributeError):
        return False


@pytest.mark.parametrize("args", [(), ("--devices", "4")])
def test_exits_nonzero_without_gpu(args):
    r = _run(ROOT, *args)
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
    assert "no GPU" in r.stderr
    assert r.stdout.startswith("card: ")       # nvidia-smi line comes first


def test_exits_nonzero_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


def test_single_card_phases_on_cpu(tmp_path, capsys):
    chip_smoke.run_single(str(tmp_path), "cpu", n_reads=2000,
                          genome_mbp=0.04, capacity=1 << 16,
                          wide_reads=600, n_lookup=4096)
    out = capsys.readouterr().out
    for phase in ("k=31 table:", "lookup: 4096 queries", "query: 8 k-mers",
                  "stats: distinct and total", "k=63 table:"):
        assert phase in out


def test_four_device_phases_on_cpu(tmp_path, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    chip_smoke.run_sharded(str(tmp_path), "cpu", 4, n_reads=2000,
                           genome_mbp=0.04, capacity=1 << 16, n_lookup=4096)
    out = capsys.readouterr().out
    for phase in ("hash-sharded k=31 table:", "minimizer-sharded k=31 table:",
                  "make_sharded_lookup over 4 shard tables"):
        assert phase in out


def test_smoke_compare_catches_a_wrong_count(tmp_path):
    """The exact compare is not vacuous: one count off fails the phase."""
    import numpy as np

    table = str(tmp_path / "t.npz")
    keys = np.array([3, 9, 12], np.uint64)
    np.savez(table, keys_hi=(keys >> np.uint64(32)).astype("<u4"),
             keys_lo=(keys & np.uint64(0xFFFFFFFF)).astype("<u4"),
             counts=np.array([1, 2, 3], "<i4"), n_unique=np.int64(3),
             kmers=np.int64(6), dropped_unique=np.int64(0),
             dropped_kmers=np.int64(0))
    ref = ((keys,), np.array([1, 2, 3], np.int64))
    chip_smoke.compare_table(table, 21, ref, "good")
    bad = ((keys,), np.array([1, 2, 4], np.int64))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_table(table, 21, bad, "bad")
