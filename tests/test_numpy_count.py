"""The vectorized NumPy exact counter (oracle.numpy_ref.count_fastq_exact),
the plain reference the device counter is compared with at scale, against
the scalar model; and the native parser's build from source."""

import collections
import gzip
import os
import shutil

import numpy as np
import pytest

from kmers_tpu.io import fastx
from kmers_tpu.oracle import numpy_ref as o

RNG = np.random.default_rng(91)


@pytest.fixture(scope="module")
def fastq_files(tmp_path_factory):
    """Records of mixed lengths (shorter than k included) with N and
    lowercase, written plain and gzipped."""
    recs = [bytes(RNG.choice(list(b"ACGTNacgt"), int(n),
                             p=[.22] * 4 + [.02] + [.025] * 4)
                  .astype(np.uint8))
            for n in RNG.integers(1, 160, 40)]
    recs.append(b"T" * 70)                  # all-T: the largest words
    d = tmp_path_factory.mktemp("numpy_count")
    body = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                    for i, s in enumerate(recs))
    plain, gz = d / "r.fastq", d / "r.fastq.gz"
    plain.write_bytes(body)
    with gzip.open(gz, "wb") as f:
        f.write(body)
    return recs, str(plain), str(gz)


def scalar_counts(recs, k):
    return collections.Counter(
        c for s in recs for _, _, c in o.canonical_windows_wide(s, k))


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32, 33, 63, 64])
def test_numpy_count_matches_scalar_model(fastq_files, k):
    recs, plain, gz = fastq_files
    want = scalar_counts(recs, k)
    for path in (plain, gz):
        planes, counts = o.count_fastq_exact(path, k, chunk_reads=7)
        keys = ([int(x) for x in planes[0]] if k <= 32 else
                [(int(h) << 64) | int(lo) for h, lo in zip(*planes)])
        assert keys == sorted(want)
        assert dict(zip(keys, counts.tolist())) == dict(want)


def test_numpy_count_max_reads(fastq_files):
    recs, _, gz = fastq_files
    planes, counts = o.count_fastq_exact(gz, 21, max_reads=10,
                                         chunk_reads=4)
    want = scalar_counts(recs[:10], 21)
    assert dict(zip(planes[0].tolist(), counts.tolist())) == dict(want)


def test_numpy_count_rejects_non_fastq(tmp_path):
    p = tmp_path / "x.fasta"
    p.write_bytes(b">a\nACGT\n>b\nACGT\n")
    with pytest.raises(ValueError, match="FASTQ"):
        o.count_fastq_exact(str(p), 3)
    with pytest.raises(ValueError):
        o.count_fastq_exact(str(p), 65)


@pytest.fixture
def native_copy(tmp_path, monkeypatch):
    """A private copy of native/ with the loader pointed at it."""
    src = os.path.dirname(fastx._SO_PATH)
    d = tmp_path / "native"
    d.mkdir()
    for name in ("Makefile", "fastx.cpp"):
        shutil.copy(os.path.join(src, name), d / name)
    monkeypatch.setattr(fastx, "_NATIVE_DIR", str(d))
    monkeypatch.setattr(fastx, "_SO_PATH", str(d / "libfastx.so"))
    monkeypatch.setattr(fastx, "_lib", None)
    monkeypatch.setattr(fastx, "_build_error", None)
    return d


def test_native_builds_from_source_atomically(native_copy):
    assert fastx.native_available()
    assert fastx.native_build_error() is None
    # built under a temporary name and renamed: nothing else is left
    assert sorted(os.listdir(native_copy)) == ["Makefile", "fastx.cpp",
                                               "libfastx.so"]


def test_native_build_failure_is_reported(native_copy):
    (native_copy / "fastx.cpp").write_text("this is not C++\n")
    assert not fastx.native_available()
    assert fastx.native_build_error()
    assert not os.path.exists(fastx._SO_PATH)
    assert sorted(os.listdir(native_copy)) == ["Makefile", "fastx.cpp"]
