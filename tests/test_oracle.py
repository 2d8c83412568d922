"""Golden-vector tests for the scalar oracle.

Every fixture below is ported from the reference's in-module test suites
(file:line citations inline); the oracle must reproduce them exactly before
any batched device op is built against it.
"""

import random

import pytest

from kmers_tpu.oracle import numpy_ref as o


# ---------------------------------------------------------------------------
# naive_impl::Kmer (naive_impl/kmer.rs tests)
# ---------------------------------------------------------------------------

def test_bin_repr():
    # naive_impl/kmer.rs:434-448
    assert o.Kmer.from_str("aaa").into_u64() == 0b000000
    assert o.Kmer.from_str("aac").into_u64() == 0b010000
    assert o.Kmer.from_str("acc").into_u64() == 0b010100
    assert o.Kmer.from_str("ccc").into_u64() == 0b010101


def test_str_repr():
    # naive_impl/kmer.rs:427-431
    assert str(o.Kmer.from_str("catagatacat")) == "catagatacat"


def test_aaa():
    # naive_impl/kmer.rs:450-466
    x = o.Kmer.from_str("aaa")
    assert x.data == 0 and x.k == 3
    for k in range(1, 33):
        x = o.Kmer.from_str("A" * k)
        assert x.data == 0 and x.k == k


def test_eq():
    # naive_impl/kmer.rs:469-474
    assert o.Kmer.from_str("aaa") == o.Kmer.from_str("AAA")
    assert o.Kmer.from_str("aCa") == o.Kmer.from_str("AcA")
    assert o.Kmer.from_str("a") != o.Kmer.from_str("aa")


def test_too_long():
    # naive_impl/kmer.rs:477-485
    with pytest.raises(ValueError):
        o.Kmer.from_str("a" * 33)
    o.Kmer.from_str("a" * 32)  # must not raise


def test_encode_binary():
    # naive_impl/kmer.rs:488-503
    for c, v in [("A", o.A), ("a", o.A), ("C", o.C), ("c", o.C),
                 ("G", o.G), ("g", o.G), ("T", o.T), ("t", o.T)]:
        assert o.encode_binary(c) == v
    with pytest.raises(ValueError):
        o.encode_binary("N")
    assert o.encode_binary_u8(ord("N")) == o.INVALID


def test_complement_base():
    # naive_impl/kmer.rs:506-511
    assert o.complement_base(o.A) == o.T
    assert o.complement_base(o.T) == o.A
    assert o.complement_base(o.C) == o.G
    assert o.complement_base(o.G) == o.C


def test_rc():
    # naive_impl/kmer.rs:387-424
    cases = [("a", "t"), ("aaa", "ttt"), ("ttt", "aaa"), ("ta", "ta"),
             ("ccg", "cgg"), ("aat", "att"),
             ("gatacataggatgg", "ccatcctatgtatc")]
    for s, rc in cases:
        assert o.Kmer.from_str(s).to_reverse_complement() == o.Kmer.from_str(rc)
    # k=1 blank: data 0, k 1 -> 't'
    assert o.Kmer(k=1, data=0).to_reverse_complement() == o.Kmer.from_str("t")


def test_canonical():
    # naive_impl/kmer.rs:292-317
    assert o.Kmer.from_str("taa").to_canonical() == o.Kmer.from_str("taa")
    assert o.Kmer.from_str("tta").to_canonical() == o.Kmer.from_str("taa")
    assert o.Kmer.from_str("atc").to_canonical() == o.Kmer.from_str("atc")
    assert o.Kmer.from_str("gat").to_canonical() == o.Kmer.from_str("atc")
    nc = o.Kmer.from_str("gatacataggatgg")
    assert nc.to_canonical() == nc.to_reverse_complement()
    assert not nc.is_canonical()
    assert o.Kmer.from_str("agatacataggatgg").is_canonical()


def test_ord():
    # naive_impl/kmer.rs:320-322
    assert o.Kmer.from_str("tcc") < o.Kmer.from_str("cct")


def test_append():
    # naive_impl/kmer.rs:325-353
    k1 = o.Kmer.from_str("att")
    assert k1.append_base_u8(ord("c")) == o.A
    assert k1 == o.Kmer.from_str("ttc")

    k1 = o.Kmer.from_str("ttcga")
    assert k1.append_base_u8(ord("g")) == o.T
    assert k1 == o.Kmer.from_str("tcgag")


def test_prepend():
    # naive_impl/kmer.rs:356-384
    k1 = o.Kmer.from_str("att")
    assert k1.prepend_base_u8(ord("c")) == o.T
    assert k1 == o.Kmer.from_str("cat")

    k1 = o.Kmer.from_str("ttcga")
    assert k1.prepend_base_u8(ord("g")) == o.A
    assert k1 == o.Kmer.from_str("gttcg")


def test_sub_kmer():
    # naive_impl/kmer.rs:530-542
    s = "ACTTGAT"
    km = o.Kmer.from_str(s)
    for i in range(len(s)):
        for j in range(i, len(s)):
            assert km.sub_kmer(i, j - i) == o.Kmer.from_str(s[i:j])


def test_minimizer_bruteforce():
    # naive_impl/kmer.rs:561-579 with a deterministic hasher
    s = "ACTTGAT"
    km = o.Kmer.from_str(s)
    state = o.mix_hash_state(seed=42)
    for w in range(1, len(s)):
        mm, off = km.minimizer(w, state)
        h_min = state.hash_word(mm.into_u64())
        for i in range(len(s) - w + 1):
            assert h_min <= state.hash_word(km.sub_kmer_word(i, w))
        assert o.Kmer.from_str(s[off:off + w]) == mm


def test_mask_table_32_quirk():
    # MASK_TABLE[32] == 0 (naive_impl/kmer.rs:584-618)
    assert o.MASK_TABLE[32] == 0
    assert o.Kmer.from_u64(0xDEADBEEF, 32).data == 0
    assert o.Kmer.from_u64((1 << 62) - 1, 31).data == (1 << 62) - 1


def test_rc_involution_fuzz():
    # quickcheck rc_identity (naive_impl/kmer.rs:280-284)
    rng = random.Random(0)
    for _ in range(500):
        w = rng.getrandbits(64)
        km = o.Kmer.from_u64(w, 31)
        assert km.to_reverse_complement().to_reverse_complement() == km


def test_to_canonical_is_canonical_fuzz():
    # quickcheck (naive_impl/kmer.rs:286-290)
    rng = random.Random(1)
    for _ in range(500):
        km = o.Kmer.from_u64(rng.getrandbits(64), 31)
        assert km.to_canonical().is_canonical()


# ---------------------------------------------------------------------------
# CanonicalKmer (canonical_kmer.rs tests)
# ---------------------------------------------------------------------------

def test_canonical_from_u64():
    # canonical_kmer.rs:244-250
    km = o.Kmer.from_str("acttg")
    ck = o.CanonicalKmer.from_u64(km.into_u64(), km.k)
    assert str(ck.get_fw_mer()) == "acttg"
    assert str(ck.get_rc_mer()) == "caagt"


def test_canonical_swap():
    # canonical_kmer.rs:262-269
    ck = o.CanonicalKmer.from_str("acttg")
    ck.swap()
    assert str(ck.get_rc_mer()) == "acttg"
    assert str(ck.get_fw_mer()) == "caagt"


def test_canonical_shift():
    # canonical_kmer.rs:272-280
    ck = o.CanonicalKmer.from_str("acttg")
    ck.append_base_u8(ord("a"))
    assert str(ck.get_fw_mer()) == "cttga"
    assert str(ck.get_rc_mer()) == "tcaag"
    ck.prepend_base_u8(ord("c"))
    assert str(ck.get_rc_mer()) == "caagg"
    assert str(ck.get_fw_mer()) == "ccttg"


def test_canonical_equivalency():
    # canonical_kmer.rs:283-297
    ck = o.CanonicalKmer.from_str("acttg")
    ck2 = o.CanonicalKmer.from_str("caagt")
    assert ck.get_kmer_equivalency(ck2.get_fw_mer()) == o.MatchType.TwinMatch
    ck2.swap()
    assert ck.get_kmer_equivalency(ck2.get_fw_mer()) == o.MatchType.IdentityMatch
    ck2.append_base_u8(ord("c"))
    assert ck.get_kmer_equivalency(ck2.get_fw_mer()) == o.MatchType.NoMatch


def test_canonical_blank():
    # canonical_kmer.rs:21-29
    ck = o.CanonicalKmer.blank_of_size(31)
    assert ck.get_fw_word() == 0
    assert ck.get_rc_word() == o.MASK64


def test_swap_identity_fuzz():
    # quickcheck swap_identity (canonical_kmer.rs:216-223)
    rng = random.Random(2)
    for _ in range(200):
        a = o.CanonicalKmer.from_u64(rng.getrandbits(64), 31)
        fw, rc = a.get_fw_word(), a.get_rc_word()
        a.swap()
        a.swap()
        assert (a.get_fw_word(), a.get_rc_word()) == (fw, rc)


# ---------------------------------------------------------------------------
# CanonicalKmerIterator (canonical_kmer_iterator.rs tests)
# ---------------------------------------------------------------------------

READ = (b"TTTTGGCCATTTTTCCTGTTCTTCAAGAAAACAGGAGATAACTAGAAGGACTAGAGAATGGGG"
        b"CTGCCAGAACTAGTGGGAAGCTCCCTAGAAATGGTGACATCGCCCACCAAACAGACC")


def test_iter_init():
    # canonical_kmer_iterator.rs:123-134
    it = o.CanonicalKmerIterator(READ, 31)
    km, pos = it.get()
    assert pos == 0
    assert km == o.CanonicalKmer.from_str(READ[0:31])


def test_iter_inc():
    # canonical_kmer_iterator.rs:137-148
    it = o.CanonicalKmerIterator(READ, 31)
    it.inc()
    km, pos = it.get()
    assert pos == 1
    assert km == o.CanonicalKmer.from_str(READ[1:32])


def test_iter_inc_by():
    # canonical_kmer_iterator.rs:151-162
    it = o.CanonicalKmerIterator(READ, 31)
    it.inc_by(10)
    km, pos = it.get()
    assert pos == 10
    assert km == o.CanonicalKmer.from_str(READ[10:41])


def test_iter_init_invalid():
    # N at pos 4 => first k-mer at pos 5 (canonical_kmer_iterator.rs:165-175)
    r = b"TTTTN" + READ[4:]
    it = o.CanonicalKmerIterator(r, 31)
    km, pos = it.get()
    assert pos == 5
    assert km == o.CanonicalKmer.from_str(r[5:36])


def test_iter_inc_by_invalid():
    # canonical_kmer_iterator.rs:178-189
    r = (b"TTTTGGCCATTTTTCCTGTTCTTCAAGAAAACAGGNAGATAACTAGAAGGACTAGAGAATGGGG"
         b"CTGCCAGAACTAGTGGGAAGCTCCCTAGAAATGGTGACATCGCCCACCAAACAGACC")
    it = o.CanonicalKmerIterator(r, 31)
    it.inc_by(5)
    km, pos = it.get()
    assert pos == 36
    assert km == o.CanonicalKmer.from_str(r[36:67])


def test_exhausted():
    # canonical_kmer_iterator.rs:192-206
    it = o.CanonicalKmerIterator(READ, 31)
    it.inc_by(20)
    assert not it.exhausted()
    it.inc_by(len(READ) - 20)
    assert it.exhausted()
    it.inc()
    assert it.exhausted()


def test_valid_positions_dense():
    # every window valid => positions 0..len-k
    k = 31
    ps = [p for p, _, _ in o.valid_kmer_positions(READ, k)]
    assert ps == list(range(len(READ) - k + 1))


def test_valid_positions_with_n():
    k = 5
    r = b"ACGTNACGTAC"
    out = o.valid_kmer_positions(r, k)
    ps = [p for p, _, _ in out]
    assert ps == [5, 6]  # windows not containing pos 4
    for p, fw, rc in out:
        assert fw == o.Kmer.from_str(r[p:p + k]).into_u64()
        assert rc == o.Kmer.from_str(r[p:p + k]).to_reverse_complement().into_u64()


# ---------------------------------------------------------------------------
# hash (hash.rs tests)
# ---------------------------------------------------------------------------

def test_lex_order():
    # hash.rs:84-104
    k = 3
    h = lambda s: o.lex_hash(o.Kmer.from_str(s).into_u64(), k)
    assert h("aaa") == 0
    assert h("aac") == 0b00001
    assert h("aaa") < h("aac")
    assert h("caa") == 0b010000
    assert h("cac") == 0b010001
    assert h("caa") < h("cac")


def test_lex_order_property():
    # lexicographic ordering property over random pairs
    rng = random.Random(3)
    k = 13
    for _ in range(200):
        s1 = "".join(rng.choice("acgt") for _ in range(k))
        s2 = "".join(rng.choice("acgt") for _ in range(k))
        h1 = o.lex_hash(o.Kmer.from_str(s1).into_u64(), k)
        h2 = o.lex_hash(o.Kmer.from_str(s2).into_u64(), k)
        assert (s1 < s2) == (h1 < h2) or s1 == s2


def test_mix_hash_stable():
    # our own stable mixer: pinned values so device path can't drift
    assert o.mix_hash(0, 0) == o.mix_hash(0, 0)
    assert o.mix_hash(1, 0) != o.mix_hash(0, 0)
    assert o.mix_hash(1, 7) != o.mix_hash(1, 8)
    # avalanche sanity: flipping one bit changes ~half the output bits
    x = o.mix_hash(0x123456789ABCDEF0)
    y = o.mix_hash(0x123456789ABCDEF1)
    assert 16 <= bin(x ^ y).count("1") <= 48


# ---------------------------------------------------------------------------
# SeqVector (seq_vector.rs tests)
# ---------------------------------------------------------------------------

def test_seq_slice():
    # seq_vector.rs:309-325: words [1,2,3]
    sv = o.SeqVector(words=[1, 2, 3], bit_len=64 * 3)
    sl = sv.as_slice()
    assert len(sl) == 96
    assert sl.get_kmer_u64(0, 32) == 1
    sl = sv.slice(1, 96)
    assert sl.get_kmer_u64(0, 32) == sv.get_kmer_u64(1, 32)
    sl = sv.slice(75, 96)
    assert sl.get_kmer_u64(0, 7) == sv.get_kmer_u64(75, 7)
    # re-slicing a slice
    assert sv.slice(10, 90).slice(5, 20).get_kmer_u64(0, 8) == sv.get_kmer_u64(15, 8)
    # unaligned read crossing the first word boundary: base 1..33 of
    # words [1,2,...] = (1 >> 2) | (2 << 62) truncated to 64 bits
    assert sv.get_kmer_u64(1, 32) == (((2 << 62) & o.MASK64) | (1 >> 2))


def test_push_chars():
    # seq_vector.rs:328-339
    sv = o.SeqVector()
    sv.push_chars(b"A" * 30)
    assert str(sv) == "A" * 30
    assert len(sv) == 30
    sv.push_chars(b"C" * 40)
    assert len(sv) == 70
    assert str(sv) == "A" * 30 + "C" * 40


def test_iter_kmers():
    # seq_vector.rs:342-356
    sv = o.SeqVector.from_bytes(b"ACTTGAT")
    kmers = [str(km) for km in sv.iter_kmers(3)]
    assert kmers == ["act", "ctt", "ttg", "tga", "gat"]


def test_seqvector_roundtrip():
    rng = random.Random(4)
    s = bytes(rng.choice(b"ACGT") for _ in range(173))
    sv = o.SeqVector.from_bytes(s)
    assert str(sv) == s.decode()
    for pos in range(0, 140, 7):
        for k in (1, 5, 31, 32):
            if pos + k <= len(sv):
                assert sv.get_kmer_u64(pos, k) == o.word_from_bytes(s[pos:pos + k])


# ---------------------------------------------------------------------------
# minimizers (seq_vector/minimizers.rs tests)
# ---------------------------------------------------------------------------

def test_leftmost_mmer():
    # minimizers.rs:221-235: all-A => leftmost pos tracks window start
    sv = o.SeqVector.from_bytes(b"AAAAAAA")
    mm = list(sv.iter_minimizers(5, 3, o.mix_hash_state(0)))
    assert mm == [(0, 0), (0, 1), (0, 2)]


def test_mmers0():
    # minimizers.rs:238-248 (LexHasherState::new(6) -- note k, not w!)
    sv = o.SeqVector.from_bytes(b"AAACAAA")
    mm = list(sv.iter_minimizers(6, 3, o.lex_hash_state(6)))
    assert mm == [(0, 0), (0, 4)]


def test_mmers1():
    # minimizers.rs:251-268 (LexHasherState::new(5))
    sv = o.SeqVector.from_bytes(b"AACCAAA")
    mm = list(sv.iter_minimizers(5, 3, o.lex_hash_state(5)))
    aac, acc, aaa = 0b010000, 0b010100, 0b000000
    assert mm == [(aac, 0), (acc, 1), (aaa, 4)]


def test_mmers2():
    # minimizers.rs:271-290 (LexHasherState::new(3))
    sv = o.SeqVector.from_bytes(b"CACACACCAC")
    mm = list(sv.iter_minimizers(7, 3, o.lex_hash_state(3)))
    aca = 0b000100
    assert mm == [(aca, 1), (aca, 1), (aca, 3), (aca, 3)]


def test_minimizer_iter_matches_bruteforce():
    # cross-implementation consistency (minimizers deque vs Kmer::minimizer)
    rng = random.Random(5)
    for _ in range(20):
        n = rng.randint(12, 40)
        s = bytes(rng.choice(b"ACGT") for _ in range(n))
        k, w = 9, 4
        sv = o.SeqVector.from_bytes(s)
        state = o.mix_hash_state(9)
        stream = list(sv.iter_minimizers(k, w, state))
        for i, (word, pos) in enumerate(stream):
            km_word = o.word_from_bytes(s[i:i + k])
            mm, off = o.minimizer_word(km_word, k, w, state)
            assert word == mm
            assert pos == i + off


# ---------------------------------------------------------------------------
# generic encoding layer (encoding/naive.rs, encoding/xor10.rs, kmer.rs)
# ---------------------------------------------------------------------------

def test_word_for_k():
    # src/kmer.rs:98-118
    assert o.word_for_k(8, 1) == 1
    assert o.word_for_k(8, 4) == 1
    assert o.word_for_k(8, 5) == 2
    assert o.word_for_k(16, 8) == 1
    assert o.word_for_k(16, 9) == 2
    assert o.word_for_k(32, 16) == 1
    assert o.word_for_k(32, 17) == 2
    assert o.word_for_k(64, 32) == 1
    assert o.word_for_k(64, 64) == 2
    assert o.word_for_k(128, 64) == 1
    assert o.word_for_k(128, 65) == 2


def test_naive_one_base_all_encodings():
    # encoding/naive.rs:168-294
    for perm, disc in o.NAIVE_PERMS.items():
        e = o.NaiveEncoding(perm)
        assert e.nuc2bits(ord("A")) == (disc >> 6) & 3
        assert e.nuc2bits(ord("C")) == (disc >> 4) & 3
        assert e.nuc2bits(ord("T")) == (disc >> 2) & 3
        assert e.nuc2bits(ord("G")) == disc & 3
        assert e.bits2nuc((disc >> 6) & 3) == ord("A")
        assert e.bits2nuc((disc >> 4) & 3) == ord("C")
        assert e.bits2nuc((disc >> 2) & 3) == ord("T")
        assert e.bits2nuc(disc & 3) == ord("G")
        assert e.complement(e.nuc2bits(ord("A"))) == e.nuc2bits(ord("T"))
        assert e.complement(e.nuc2bits(ord("C"))) == e.nuc2bits(ord("G"))
        assert e.complement(e.nuc2bits(ord("T"))) == e.nuc2bits(ord("A"))
        assert e.complement(e.nuc2bits(ord("G"))) == e.nuc2bits(ord("C"))


def test_k15pu8():
    # encoding/naive.rs:296-313
    e = o.NaiveEncoding("ACGT")
    arr = e.encode(b"TAAGGATTCTAATCA", 8, 4)
    assert arr == [131, 242, 13, 7]
    assert [o.generic_get(arr, 8, i) for i in range(15)] == \
        [3, 0, 0, 2, 2, 0, 3, 3, 1, 3, 0, 0, 3, 1, 0]
    assert e.decode(arr, 8) == b"TAAGGATTCTAATCAA"
    assert e.decode(e.rev_comp(arr, 8, 15), 8) == b"TGATTAGAATCCTTAA"


def test_k15pu16():
    # encoding/naive.rs:316-334
    e = o.NaiveEncoding("ACGT")
    arr = e.encode(b"TAAGGATTCTAATCA", 16, 2)
    assert arr == [62083, 1805]
    assert e.decode(arr, 16) == b"TAAGGATTCTAATCAA"
    assert e.decode(e.rev_comp(arr, 16, 15), 16) == b"TGATTAGAATCCTTAA"


def test_k15pu32():
    # encoding/naive.rs:337-355
    e = o.NaiveEncoding("ACGT")
    arr = e.encode(b"TAAGGATTCTAATCA", 32, 1)
    assert arr == [118354563]
    assert e.decode(arr, 32) == b"TAAGGATTCTAATCAA"
    assert e.decode(e.rev_comp(arr, 32, 15), 32) == b"TGATTAGAATCCTTAA"


def test_k30pu32():
    # encoding/naive.rs:358-385
    e = o.NaiveEncoding("ACGT")
    arr = e.encode(b"TAAGGATTCTAATCATAAGGATTCTAATCA", 32, 2)
    assert arr == [3339580035, 29588640]
    assert e.decode(arr, 32) == b"TAAGGATTCTAATCATAAGGATTCTAATCAAA"
    assert e.decode(e.rev_comp(arr, 32, 30), 32) == b"TGATTAGAATCCTTATGATTAGAATCCTTAAA"


def test_k45pu64():
    # encoding/naive.rs:388-416
    e = o.NaiveEncoding("ACGT")
    arr = e.encode(b"TAAGGATTCTAATCATAAGGATTCTAATCATAAGGATTCTAATCA", 64, 2)
    assert arr == [3585846758293238403, 7397160]
    assert e.decode(arr, 64) == \
        b"TAAGGATTCTAATCATAAGGATTCTAATCATAAGGATTCTAATCA" + b"A" * 19
    assert e.decode(e.rev_comp(arr, 64, 45), 64) == \
        b"TGATTAGAATCCTTATGATTAGAATCCTTATGATTAGAATCCTTA" + b"A" * 19


def test_k65pu128():
    # encoding/naive.rs:419-445
    e = o.NaiveEncoding("ACGT")
    seq = b"TAAGGATTCTAATCATAAGGATTCTAATCATAAGGATTCTAATCATAAGGATTCTAATCAGGGGG"
    arr = e.encode(seq, 128, 2)
    assert arr == [226115275135941975929349834069397860995, 2]
    assert e.decode(arr, 128) == seq + b"A" * 63
    assert e.decode(e.rev_comp(arr, 128, 65), 128) == \
        b"CCCCCTGATTAGAATCCTTATGATTAGAATCCTTATGATTAGAATCCTTATGATTAGAATCCTTA" + b"A" * 63


def test_xor10_one_base():
    # encoding/xor10.rs:118-157 (commented-out but golden)
    e = o.Xor10Encoding()
    assert e.nuc2bits(ord("A")) == 0b00
    assert e.nuc2bits(ord("C")) == 0b01
    assert e.nuc2bits(ord("T")) == 0b10
    assert e.nuc2bits(ord("G")) == 0b11
    assert e.bits2nuc(0b00) == ord("A")
    assert e.bits2nuc(0b01) == ord("C")
    assert e.bits2nuc(0b10) == ord("T")
    assert e.bits2nuc(0b11) == ord("G")
    for n in b"ACTG":
        comp = {ord("A"): ord("T"), ord("T"): ord("A"),
                ord("C"): ord("G"), ord("G"): ord("C")}[n]
        assert e.complement(e.nuc2bits(n)) == e.nuc2bits(comp)


def test_xor10_revcomp_correct():
    # Xor10 B==1 fast path is buggy in the reference (xor10.rs:84, tests
    # disabled); we implement the *correct* semantics and check it against
    # string-level reverse complement.
    e = o.Xor10Encoding()
    seq = b"TAAGGATTCTAATCA"
    arr = e.encode(seq, 64, 1)
    rc = e.rev_comp(arr, 64, 15)
    want = b"TGATTAGAATCCTTA"
    assert e.decode(rc, 64)[:15] == want


def test_generic_with_data():
    # src/kmer.rs:156-165
    arr = [0b11100100]
    assert o.generic_get(arr, 8, 0) == 0b00
    assert o.generic_get(arr, 8, 1) == 0b01
    assert o.generic_get(arr, 8, 2) == 0b10
    assert o.generic_get(arr, 8, 3) == 0b11


def test_generic_naive_encoder():
    # src/kmer.rs:168-184
    e = o.NaiveEncoding("ACTG")
    arr = e.encode(b"ACTG", 8, 1)
    assert [o.generic_get(arr, 8, i) for i in range(4)] == [0b00, 0b01, 0b10, 0b11]
    e = o.NaiveEncoding("TAGC")
    arr = e.encode(b"ACTG", 8, 1)
    assert [o.generic_get(arr, 8, i) for i in range(4)] == [0b01, 0b11, 0b00, 0b10]


def test_kmer_prefix():
    # src/kmer.rs:187-196: get_prefix(4) reads 2*4+1 bits (inclusive
    # off-by-one, replicated)
    e = o.NaiveEncoding("ACGT")
    arr = e.encode(b"GTAC", 64, 1)
    pref = o.generic_get_prefix(arr, 64, 4)
    assert pref == 0b01001110
    assert o.bitmer_to_bytes(pref, 4) == b"GTAC"


def test_bitmer_to_bytes():
    # src/kmer.rs:199-203
    assert o.bitmer_to_bytes(0b01001110, 4) == b"GTAC"
