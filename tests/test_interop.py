"""simple_sds serialization interop + word-level push_chars.

The reference's SeqVector wraps simple_sds::RawVector and builds from
RawVector/IntVector with layout asserts (seq_vector.rs:244-258); these
tests demonstrate (not just assert) that a sequence packed by the ORACLE's
independent u64 packing round-trips through the device SeqVector
byte-identically, in both directions.
"""

import random

import numpy as np
import pytest

from kmers_tpu.oracle import numpy_ref as o
from kmers_tpu.ops.seqvector import SeqVector

RNG = random.Random(4242)


def rand_seq(n):
    return bytes(RNG.choice(b"ACGT") for _ in range(n))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 33, 100, 257])
def test_oracle_bytes_load_into_device(n):
    seq = rand_seq(n)
    blob = o.SeqVector.from_bytes(seq).to_simple_sds()
    sv = SeqVector.from_simple_sds(blob)
    assert len(sv) == n
    assert sv.to_string() == seq.decode()
    # and the re-serialization is byte-identical
    assert sv.to_simple_sds() == blob


@pytest.mark.parametrize("n", [1, 40, 64, 129])
def test_device_bytes_load_into_oracle(n):
    seq = rand_seq(n)
    blob = SeqVector.from_bytes(seq).to_simple_sds()
    osv = o.SeqVector.from_simple_sds(blob)
    assert len(osv) == n
    assert str(osv) == seq.decode()
    k = min(n, 17)
    dev = SeqVector.from_simple_sds(blob)
    for pos in range(0, n - k + 1, 7):
        assert dev.get_kmer_u64(pos, k) == osv.get_kmer_u64(pos, k)


def test_int_vector_wrapper():
    seq = rand_seq(50)
    raw = o.SeqVector.from_bytes(seq).to_simple_sds()
    blob = (50).to_bytes(8, "little") + (2).to_bytes(8, "little") + raw
    sv = SeqVector.from_simple_sds_int_vector(blob)
    assert sv.to_string() == seq.decode()
    bad_width = (50).to_bytes(8, "little") + (3).to_bytes(8, "little") + raw
    with pytest.raises(ValueError, match="width"):
        SeqVector.from_simple_sds_int_vector(bad_width)


def test_odd_bit_length_rejected():
    blob = (3).to_bytes(8, "little") + (1).to_bytes(8, "little") + bytes(8)
    with pytest.raises(ValueError, match="even"):
        SeqVector.from_simple_sds(blob)


def test_save_load_file(tmp_path):
    seq = rand_seq(123)
    sv = SeqVector.from_bytes(seq)
    p = str(tmp_path / "sv.sds")
    sv.save_simple_sds(p)
    assert SeqVector.load_simple_sds(p).to_string() == seq.decode()


@pytest.mark.parametrize("initial,appends", [
    (0, [5, 16, 3]),
    (7, [9, 32, 1]),
    (16, [16, 15]),
    (33, [31, 64, 2]),
])
def test_push_chars_word_level(initial, appends):
    """push_chars appends at the packed-word level; result identical to
    packing the concatenation from scratch, and to the oracle."""
    seq = rand_seq(initial)
    sv = SeqVector.from_bytes(seq)
    osv = o.SeqVector.from_bytes(seq)
    for n in appends:
        chunk = rand_seq(n)
        sv.push_chars(chunk)
        osv.push_chars(chunk)
        seq += chunk
    assert sv.to_string() == seq.decode() == str(osv)
    assert sv.to_simple_sds() == osv.to_simple_sds()


def test_hash_one_compat():
    """hash_one(state, x) name parity (hash.rs:10-20): Kmer and raw word
    hash identically (naive_impl/kmer.rs:545-558)."""
    from kmers_tpu.compat import Kmer, hash_one, lex_hash_state, mix_hash_state

    km = Kmer.from_str("ACGTTGCA")
    for state in (lex_hash_state(8), mix_hash_state(7)):
        assert hash_one(state, km) == hash_one(state, km.data)
        assert hash_one(state, km) == state.hash_word(km.data)


# -- checked-in golden fixtures (format-spec-derived bytes) -------------------
#
# No Rust toolchain is available to run the reference crate itself;
# these binaries were derived by hand from the simple-sds
# serialization format and the reference's 2-bit LSB-first packing and
# checked in, so any drift in our serializer breaks against PINNED bytes,
# not against code that could drift with it.

import os

_DATA = os.path.join(os.path.dirname(__file__), "data")


def test_golden_rawvector_fixture_roundtrip():
    from kmers_tpu.ops.seqvector import SeqVector

    path = os.path.join(_DATA, "taaggattctaatca.rawvector")
    sv = SeqVector.load_simple_sds(path)
    assert sv.to_string() == "TAAGGATTCTAATCA"
    with open(path, "rb") as f:
        assert SeqVector.from_str("TAAGGATTCTAATCA").to_simple_sds() \
            == f.read()


def test_golden_intvector_fixture():
    from kmers_tpu.ops.seqvector import SeqVector

    with open(os.path.join(_DATA, "taaggattctaatca.intvector"), "rb") as f:
        sv = SeqVector.from_simple_sds_int_vector(f.read())
    assert sv.to_string() == "TAAGGATTCTAATCA"


def test_golden_multiword_fixture_roundtrip():
    from kmers_tpu.ops.seqvector import SeqVector

    seq = "TAAGGATTCTAATCAACGTACGTACGTACGTTTTTGGGGCCCCAAAA" * 2
    path = os.path.join(_DATA, "multiword94.rawvector")
    sv = SeqVector.load_simple_sds(path)
    assert sv.to_string() == seq
    with open(path, "rb") as f:
        assert SeqVector.from_str(seq).to_simple_sds() == f.read()
