"""Stage 03 — "fabulous 2.0" re-phasing of Supernova pseudohap2 output.

Replaces the four reference binaries
(/root/reference/03.mkoutput_by_fabulous2.0/src_main/{Split,classify,
MergePhaseResult,GenSq}.cpp) plus the driver's grep/awk routing
(mkoutput_by_fabulous2.0.sh:119-126).  The segment classifier reuses the
device probe table; everything else is small-data host transforms.

Parity notes:
  * Split: per scaffold the pseudohap2 .idx line "scaffid c0 c1 c2 ..."
    holds an even-length coordinate list; even-index pairs are
    homozygous spans, odd-index pairs are phased (bubble) spans
    (appcommon/Idx.h:21-36).  phb segments use odd seq_index 1,3,..,
    homo segments even 0,2,..; homo comes from the .1 fasta only; 60-col
    wrap (Split.cpp:82-119,146-162).
  * classify(fasta): the reference stores each marker string AND its
    reverse complement and probes raw substrings
    (03/src_main/classify.cpp:51-70,203-218) — equivalent to canonical
    probing with windows restricted to uppercase ACGT.  hapCounts are
    normalized by the marker file LINE counts (not set sizes), and the
    verdict/print logic is PrintOutput (classify.cpp:104-135), including
    the literal "0.0" for all-zero sequences.
  * MergePhaseResult: pairing, the supernova-majority prior, and the
    float32 weight comparisons follow MergePhaseResult.cpp:57-156.
  * GenSq: alternating homo/phased block chain, 80-col output, block
    boundary idx, and the supplement map keyed by (scaff_id, phase_id)
    ONLY — the reference's Scaff_Seg_Head::operator< ignores seq_index
    (appcommon/SegmentFa.h:12-16), so later supplement segments of a
    scaffold overwrite the seq but keep the first segment's name; we
    reproduce that observable behavior (GenSq.cpp:237-271).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from hast_jax.io import fastq as FQ
from hast_jax.ops import encode as E
from hast_jax.ops import hashtable as H

# ---------------------------------------------------------------------------
# shared small pieces
# ---------------------------------------------------------------------------


def wrap_seq(seq: bytes, n: int) -> bytes:
    """BGIQD::SEQ::seq::Seq(n): wrap at n cols, trailing newline, empty->''."""
    if not seq:
        return b""
    return b"\n".join(seq[i:i + n] for i in range(0, len(seq), n)) + b"\n"


def parse_seg_head(name: bytes | str) -> tuple[int, int, int]:
    """'12_3_1' (or '>12_3_1') -> (scaff_id, seq_index, phase_id)."""
    if isinstance(name, bytes):
        name = name.decode()
    name = name.lstrip(">")
    a, b, c = name.split("_")
    return int(a), int(b), int(c)


@dataclasses.dataclass
class Idx:
    scaffold_id: int
    indexs: list[int]

    @classmethod
    def from_line(cls, line: str) -> "Idx":
        parts = line.split()
        return cls(int(parts[0]), [int(x) for x in parts[1:]])

    def is_valid(self) -> bool:
        return len(self.indexs) > 1 and len(self.indexs) % 2 == 0

    def is_multi(self) -> bool:
        return len(self.indexs) > 2

    def phase_parts(self) -> list[tuple[int, int]]:
        if not self.is_valid() or not self.is_multi():
            return []
        return [(self.indexs[i], self.indexs[i + 1])
                for i in range(1, len(self.indexs) - 2, 2)]

    def homo_parts(self) -> list[tuple[int, int]]:
        if not self.is_valid():
            return []
        return [(self.indexs[i], self.indexs[i + 1])
                for i in range(0, len(self.indexs) - 1, 2)]


def _load_idx(path: str) -> dict[int, Idx]:
    cache: dict[int, Idx] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx = Idx.from_line(line)
            assert idx.is_valid(), line
            cache[idx.scaffold_id] = idx
    return cache


def _scaff_id_of(head: bytes) -> int:
    """std::stoul of the first header token (Id_Desc_Head.Id)."""
    tok = head.split()[0] if head.split() else b""
    digits = b""
    for ch in tok:
        if chr(ch).isdigit():
            digits += bytes([ch])
        else:
            break
    if not digits:
        raise ValueError(f"non-numeric scaffold id in header: {head!r}")
    return int(digits)


# ---------------------------------------------------------------------------
# Split (Split.cpp)
# ---------------------------------------------------------------------------

def split_pseudohap(fa_1: str, fa_2: str, idx_1: str, idx_2: str,
                    prefix: str) -> dict[str, str]:
    """pseudohap2 fastas + idx -> phb.1.fa / phb.2.fa / homo.fa."""
    names = {
        "phb1": prefix + ".phb.1.fa",
        "phb2": prefix + ".phb.2.fa",
        "homo": prefix + ".homo.fa",
    }
    idx1 = _load_idx(idx_1)
    fas1 = list(FQ.fasta_records(fa_1))

    with open(names["phb1"], "wb") as out:
        for head, seq in fas1:
            sid = _scaff_id_of(head)
            idx = idx1[sid]
            if not idx.is_multi():
                continue
            i = 1
            for start, end in idx.phase_parts():
                out.write(b">%d_%d_1\n" % (sid, i))
                out.write(wrap_seq(seq[start:end], 60))
                i += 2

    with open(names["homo"], "wb") as out:
        for head, seq in fas1:
            sid = _scaff_id_of(head)
            idx = idx1[sid]
            i = 0
            for start, end in idx.homo_parts():
                out.write(b">%d_%d_0\n" % (sid, i))
                out.write(wrap_seq(seq[start:end], 60))
                i += 2

    del fas1
    idx2 = _load_idx(idx_2)
    with open(names["phb2"], "wb") as out:
        for head, seq in FQ.fasta_records(fa_2):
            sid = _scaff_id_of(head)
            idx = idx2[sid]
            if not idx.is_multi():
                continue
            i = 1
            for start, end in idx.phase_parts():
                out.write(b">%d_%d_2\n" % (sid, i))
                out.write(wrap_seq(seq[start:end], 60))
                i += 2
    return names


# ---------------------------------------------------------------------------
# classify (fasta segments) — 03/src_main/classify.cpp
# ---------------------------------------------------------------------------

_UPPER_ACGT = np.zeros(256, bool)
for _c in b"ACGT":
    _UPPER_ACGT[_c] = True

_SEG = 4096   # device piece length (long records chop with k-1 overlap)


def _build_segment_table(hap_files: list[str]):
    """Combined canonical table; normalization uses marker LINE counts
    (03/src_main/classify.cpp:51-70 total_kmers)."""
    his, los, pays, totals = [], [], [], []
    k = None
    for h, path in enumerate(hap_files):
        hi, lo, kk = E.load_mer_file(path, k_expect=k)
        k = kk
        his.append(hi)
        los.append(lo)
        pays.append(np.full(hi.size, 1 << h, np.uint32))
        totals.append(hi.size)
        print(f"Recorded {hi.size} haplotype {h} specific {k}-mers",
              file=sys.stderr)
    table = H.build_table(np.concatenate(his), np.concatenate(los),
                          np.concatenate(pays), k,
                          set_sizes=tuple(totals))
    return table


def _segment_hits_stream(table: H.KmerTable, records,
                         target_pieces: int = 2048):
    """Stream (names, hits) over record chunks of bounded device work.

    The reference classifier streams segments through a job pool with
    10000/3000 watermarks (03/src_main/classify.cpp:180-230) so memory
    stays constant in the input size; this is the same contract: only
    one chunk of records (~target_pieces device pieces, plus the
    largest single record) is resident at a time, and verdicts emit in
    input order chunk by chunk.
    """
    k = table.k
    step = _SEG - (k - 1)
    names: list[bytes] = []
    seqs: list[bytes] = []
    n_pieces = 0
    for head, seq in records:
        names.append(head)
        seqs.append(seq)
        if len(seq) >= k:
            n_pieces += max(1, -(-(len(seq) - (k - 1)) // step))
        if n_pieces >= target_pieces:
            yield names, _segment_hits_batch(table, seqs)
            names, seqs, n_pieces = [], [], 0
    if names:
        yield names, _segment_hits_batch(table, seqs)


def _segment_hits_batch(table: H.KmerTable, seqs: list[bytes]):
    """Vectorized (device) hit counts over one bounded chunk of
    sequences (callers stream chunks via _segment_hits_stream)."""
    k = table.k
    data = jnp.asarray(table.data)
    results = np.zeros((len(seqs), 2), np.int64)
    # chunk all sequences into bounded pieces with k-1 overlap
    step = _SEG - (k - 1)
    pieces: list[bytes] = []
    owner: list[int] = []
    for i, seq in enumerate(seqs):
        if len(seq) < k:
            continue
        for p in range(0, max(1, len(seq) - (k - 1)), step):
            pieces.append(seq[p:p + _SEG])
            owner.append(i)
    B = 512
    for start in range(0, len(pieces), B):
        sub = pieces[start:start + B]
        L = max(max(len(s) for s in sub), k)
        L = -(-L // 128) * 128
        buf = np.zeros((B, L), np.uint8)
        lengths = np.zeros(B, np.int32)
        for j, s in enumerate(sub):
            buf[j, :len(s)] = np.frombuffer(s, np.uint8)
            lengths[j] = len(s)
        good = _UPPER_ACGT[buf]
        v0, v1 = _strict_vote(data, jnp.asarray(buf), jnp.asarray(lengths),
                              jnp.asarray(good), k, table.max_probe,
                              table.fmt)
        v0 = np.asarray(v0)
        v1 = np.asarray(v1)
        for j in range(len(sub)):
            results[owner[start + j], 0] += int(v0[j])
            results[owner[start + j], 1] += int(v1[j])
    return results


@functools.partial(jax.jit, static_argnames=("k", "max_probe", "fmt"))
def _strict_vote(data, seqs_u8, lengths, good, k, max_probe, fmt):
    codes = E.encode_bases(seqs_u8)
    hi, lo = E.canonical_kmers(codes, k)
    valid = E.window_valid(good, lengths, k)
    # fmt must follow the built table: H.build_table auto-picks "quot"
    # for realistic marker counts, and a full-format probe on quot data
    # silently returns payload 0 for every key.
    pay = H.probe_table(data, hi, lo, k, fmt, max_probe)
    pay = jnp.where(valid, pay, 0)
    return (jnp.sum(pay & 1, axis=-1, dtype=jnp.int32),
            jnp.sum((pay >> 1) & 1, axis=-1, dtype=jnp.int32))


def classify_segments(hap_files: list[str], read_files: list[str], out,
                      fmt: str = "fasta") -> None:
    """Stage-03 classify main(): per-sequence verdict lines on stdout.

    Output (03/src_main/classify.cpp:104-135): "name\\tverdict\\tweight"
    where verdict is haplotype0/haplotype1/ambiguous; weight is the
    normalized top count at %0.6f, or the literal 0.0 for all-zero.
    """
    table = _build_segment_table(hap_files)
    totals = table.set_sizes
    for path in read_files:
        if fmt == "fasta":
            records = FQ.fasta_records(path)
        else:
            records = ((rec[0][1:], rec[1])
                       for rec in FQ.fastq_records(path))
        for names, hits in _segment_hits_stream(table, records):
            for i, head in enumerate(names):
                counts = [hits[i, 0] / totals[0], hits[i, 1] / totals[1]]
                out.write(_verdict_line(head.decode(), counts))


def _verdict_line(name: str, counts: list[float]) -> str:
    best = 0.0
    second = 0.0
    hap = ""
    for i, c in enumerate(counts):
        if c > 0 and c < best and c > second:
            second = c
        if c > 0 and c > best:
            hap = f"haplotype{i}"
            second = best
            best = c
    if second == 0 and best != 0:
        return f"{name}\t{hap}\t{best:0.6f}\n"
    if best == 0 and second == 0:
        return f"{name}\tambiguous\t0.0\n"
    if best / second > 1:
        return f"{name}\t{hap}\t{best:0.6f}\n"
    return f"{name}\tambiguous\t{best:0.6f}\n"


def route_phasing(phasing_out: str, prefix: str) -> dict[str, str]:
    """phasing.out -> father/mother/ambiguous idx (driver's grep/awk,
    mkoutput_by_fabulous2.0.sh:124-126): '$1\\t$3' per matching line."""
    names = {
        "father": prefix + ".phb.12.father.idx",
        "mother": prefix + ".phb.12.mother.idx",
        "ambiguous": prefix + ".phb.12.ambiguous.idx",
    }
    outs = {key: open(p, "w") for key, p in names.items()}
    with open(phasing_out) as f:
        for line in f:
            cols = line.split()
            if len(cols) < 3:
                continue
            # grep semantics: substring match anywhere in the line
            for key, pat in (("father", "haplotype0"),
                             ("mother", "haplotype1"),
                             ("ambiguous", "ambiguous")):
                if pat in line:
                    outs[key].write(f"{cols[0]}\t{cols[2]}\n")
    for o in outs.values():
        o.close()
    return names


# ---------------------------------------------------------------------------
# MergePhaseResult (MergePhaseResult.cpp)
# ---------------------------------------------------------------------------

FATHER, MOTHER, HOMO = 1, 2, 3


def _oppo(t: int) -> int:
    assert t != HOMO
    return MOTHER if t == FATHER else FATHER


@dataclasses.dataclass
class _Elem:
    trio: int = 0
    paired: int = 0
    super_type: int = 0   # 1 or 2
    line: str = ""
    weight: np.float32 = np.float32(0)


def merge_phase_result(prefix: str, father_ids: str, mother_ids: str,
                       homo_ids: str) -> dict[str, str]:
    data: dict[int, dict[int, dict[int, _Elem]]] = {}

    def load(path: str, trio: int):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                name = parts[0]
                weight = np.float32(parts[1]) if len(parts) > 1 \
                    else np.float32(0)
                sid, seg, phase = parse_seg_head(name)
                elem = _Elem(trio=trio, line=name, weight=weight,
                             super_type=phase)
                if phase not in (1, 2):
                    raise ValueError(f"bad phase id in {name}")
                data.setdefault(sid, {}).setdefault(seg, {})[phase] = elem

    load(father_ids, FATHER)
    load(mother_ids, MOTHER)
    load(homo_ids, HOMO)

    pairs = []
    for sid in sorted(data):
        for seg in sorted(data[sid]):
            pair = data[sid][seg]
            if 1 not in pair or 2 not in pair:
                raise ValueError(
                    f"unpaired phase block scaff={sid} seg={seg}")
            pairs.append((pair[1], pair[2]))

    # GenTrioBinPairedResult
    for e1, e2 in pairs:
        if e1.trio != e2.trio and e1.trio != HOMO and e2.trio != HOMO:
            e1.paired, e2.paired = e1.trio, e2.trio
        elif e1.trio == e2.trio:
            e1.paired = e2.paired = HOMO
        elif e1.trio == HOMO:
            e2.paired = e2.trio
            e1.paired = _oppo(e2.trio)
        else:
            e1.paired = e1.trio
            e2.paired = _oppo(e1.trio)

    # CountSupernovaType1: majority vote over type-1 paired results
    counts = {FATHER: 0, MOTHER: 0, HOMO: 0}
    for e1, e2 in pairs:
        vote = e1.paired if e1.super_type == 1 else e2.paired
        counts[vote] += 1
    total = counts[FATHER] + counts[MOTHER] + counts[HOMO]
    father_fac = np.float32(counts[FATHER]) / np.float32(total)
    mother_fac = np.float32(counts[MOTHER]) / np.float32(total)
    homo_fac = np.float32(counts[HOMO]) / np.float32(total)
    print(f" father_fac {father_fac:g}", file=sys.stderr)
    print(f" mother_fac {mother_fac:g}", file=sys.stderr)
    print(f" homo_fac {homo_fac:g}", file=sys.stderr)
    type_1_eq = FATHER if father_fac >= mother_fac else MOTHER

    # SetAllHomo: resolve residual both-homo pairs
    final_homo: set[str] = set()
    for e1, e2 in pairs:
        if e1.paired == e2.paired:
            assert e1.paired == HOMO
            if e1.weight > e2.weight:
                e1.paired = e1.trio
                e2.paired = _oppo(e1.trio)
            elif e1.weight < e2.weight:
                e2.paired = e2.trio
                e1.paired = _oppo(e2.trio)
            else:
                e1.paired = type_1_eq if e1.super_type == 1 \
                    else _oppo(type_1_eq)
                e2.paired = type_1_eq if e2.super_type == 1 \
                    else _oppo(type_1_eq)
                final_homo.add(e1.line)

    names = {
        "father": prefix + ".merge.father.ids",
        "mother": prefix + ".merge.mother.ids",
        "homo": prefix + ".merge.homo.ids",
    }
    with open(names["father"], "w") as f:
        for e1, e2 in pairs:
            f.write((e1.line if e1.paired == FATHER else e2.line) + "\n")
    with open(names["mother"], "w") as f:
        for e1, e2 in pairs:
            f.write((e2.line if e1.paired == FATHER else e1.line) + "\n")
    with open(names["homo"], "w") as f:
        for line in sorted(final_homo):
            f.write(line + "\n")
    return names


# ---------------------------------------------------------------------------
# GenSq (GenSq.cpp)
# ---------------------------------------------------------------------------

def gen_sq(prefix: str, prefer: str) -> dict[str, str]:
    assert prefer in ("pat", "mat")
    # load segment fastas: cache[scaff][seq_index][phase] = seq
    cache: dict[int, dict[int, dict[int, bytes]]] = {}
    for suffix in (".phb.1.fa", ".phb.2.fa", ".homo.fa"):
        for head, seq in FQ.fasta_records(prefix + suffix):
            sid, seg, phase = parse_seg_head(head)
            cache.setdefault(sid, {}).setdefault(seg, {})[phase] = seq

    # phased block -> (father_seq_key, mother_seq_key)
    phased: dict[int, dict[int, dict[str, tuple[int, int, int]]]] = {}
    for which, path in (("father", prefix + ".merge.father.ids"),
                        ("mother", prefix + ".merge.mother.ids")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                sid, seg, phase = parse_seg_head(line)
                phased.setdefault(sid, {}).setdefault(seg, {})[which] = (
                    sid, seg, phase)

    out_key = "father" if prefer == "pat" else "mother"
    fa_path = f"{prefix}.{out_key}.fa"
    idx_path = f"{prefix}.{out_key}.idx"
    idx_cache: dict[int, list[int]] = {}
    with open(fa_path, "wb") as out:
        for sid in sorted(cache):
            blocks = {}
            for seg, phases in cache[sid].items():
                if 0 in phases:
                    blocks[seg] = phases[0]
            for seg, sides in phased.get(sid, {}).items():
                key = sides.get(out_key)
                if key is None:
                    raise ValueError(
                        f"missing {out_key} block scaff={sid} seg={seg}")
                blocks[seg] = cache[key[0]][key[1]][key[2]]
            n = len(blocks)
            assert n % 2 == 1, (sid, n)
            idx = [0]
            parts = []
            for i in range(n):
                if i not in blocks:
                    raise ValueError(f"missing block {sid}/{i}")
                parts.append(blocks[i])
                idx.append(idx[-1] + len(blocks[i]))
            seq = b"".join(parts)
            out.write(b">%d\n" % sid)
            out.write(wrap_seq(seq, 80))
            idx_cache[sid] = idx
    with open(idx_path, "w") as out:
        for sid in sorted(idx_cache):
            out.write(str(sid) + "".join(f" {i}" for i in idx_cache[sid])
                      + "\n")

    # supplement: non-preferred branch of globally-voted homo pairs,
    # keyed by (scaff_id, phase_id) only — reference operator< quirk.
    supp_key_order: list[tuple[int, int]] = []
    supp_name: dict[tuple[int, int], tuple[int, int]] = {}
    supp_seq: dict[tuple[int, int], bytes] = {}
    other = "mother" if prefer == "pat" else "father"
    with open(prefix + ".merge.homo.ids") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sid, seg, phase = parse_seg_head(line)
            sides = phased[sid][seg]
            key = sides[other]
            mapkey = (sid, phase)
            if mapkey not in supp_name:
                supp_name[mapkey] = (sid, seg)
                supp_key_order.append(mapkey)
            supp_seq[mapkey] = cache[key[0]][key[1]][key[2]]
    supp_path = prefix + ".supplement.fa"
    with open(supp_path, "wb") as out:
        for mapkey in sorted(supp_name):
            sid, seg = supp_name[mapkey]
            out.write(b">scaff_%d_segment_%d\n" % (sid, seg))
            out.write(wrap_seq(supp_seq[mapkey], 80))
    return {out_key: fa_path, "idx": idx_path, "supplement": supp_path}


# ---------------------------------------------------------------------------
# driver (mkoutput_by_fabulous2.0.sh)
# ---------------------------------------------------------------------------

def mkoutput(assembly_path: str, prefix: str, paternal_mer: str,
             maternal_mer: str, prefer: str = "paternal",
             workdir: str = ".") -> dict[str, str]:
    """Full stage 03: Split -> classify -> route -> merge -> GenSq."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        p = prefix
        split_pseudohap(
            os.path.join(assembly_path, p + ".1.fasta"),
            os.path.join(assembly_path, p + ".2.fasta"),
            os.path.join(assembly_path, p + ".1.idx"),
            os.path.join(assembly_path, p + ".2.idx"), p)
        with open(p + ".phb.12.fa", "wb") as out:
            for name in (p + ".phb.1.fa", p + ".phb.2.fa"):
                out.write(open(name, "rb").read())
        with open("phasing.out", "w") as out:
            classify_segments([paternal_mer, maternal_mer],
                              [p + ".phb.12.fa"], out)
        routed = route_phasing("phasing.out", p)
        merge_phase_result(p, routed["father"], routed["mother"],
                           routed["ambiguous"])
        result = gen_sq(p, "pat" if prefer == "paternal" else "mat")
        # final symlinks (mkoutput_by_fabulous2.0.sh:142-152): primary ->
        # the preferred hap's fa; secondary -> the other hap's fa IF that
        # file exists (GenSq only writes the preferred side, so secondary
        # appears only when an earlier opposite-prefer run left its fa).
        out_key = "father" if prefer == "paternal" else "mother"
        other_key = "mother" if prefer == "paternal" else "father"
        # symlink targets must be basenamed: a relative target resolves
        # from the LINK's directory, so with a prefix like "out/hap" a
        # target "out/hap.father.fa" would dangle at "out/out/..."
        primary = p + ".primary.fa"
        if not os.path.exists(primary):
            os.symlink(os.path.basename(f"{p}.{out_key}.fa"), primary)
        secondary = p + ".secondary.fa"
        other_fa = f"{p}.{other_key}.fa"
        if os.path.exists(other_fa) and not os.path.exists(secondary):
            os.symlink(os.path.basename(other_fa), secondary)
            result["secondary"] = secondary
        result["primary"] = primary
        return result
    finally:
        os.chdir(cwd)
