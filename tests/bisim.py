"""Bisulfite read simulator: synthetic genome -> aligned reads -> SAM + BAM.

Generates biologically-shaped test data with a known methylation state so
bam2pat can be validated both self-consistently and against the reference's
match_maker|patter binaries (fed the same reads as SAM text).
"""

import numpy as np

from wgbs_tools_tpu.pipeline.bam import BamRecord, write_bam


class SimRead:
    def __init__(self, qname, flag, chrom, pos0, seq, cigar_str, mapq=60,
                 qual=None):
        self.qname = qname
        self.flag = flag
        self.chrom = chrom
        self.pos0 = pos0  # 0-based
        self.seq = seq  # bytes
        self.cigar_str = cigar_str
        self.mapq = mapq
        self.qual = qual  # phred string (ascii+33) or None -> 'F' * len

    def cigar_list(self):
        out = []
        num = ""
        for ch in self.cigar_str:
            if ch.isdigit():
                num += ch
            else:
                out.append((ch, int(num)))
                num = ""
        return out

    def sam_line(self):
        return "\t".join(
            [
                self.qname,
                str(self.flag),
                self.chrom,
                str(self.pos0 + 1),
                str(self.mapq),
                self.cigar_str,
                "*",
                "0",
                "0",
                self.seq.decode(),
                self.qual if self.qual is not None else "F" * len(self.seq),
            ]
        )


def bisulfite_seq(ref_seq, start0, length, meth_state, bottom, conv_rate=1.0,
                  rng=None):
    """Reference slice -> bisulfite-converted read sequence (forward coords).

    meth_state: bool array per genome position (True = methylated C of a CpG).
    Top strand: unmethylated C -> T. Bottom strand: unmethylated C (on the
    bottom strand, i.e. G on the forward strand) -> A.
    """
    seq = bytearray(ref_seq[start0 : start0 + length])
    n = len(ref_seq)
    for i in range(len(seq)):
        g = start0 + i
        if not bottom and seq[i] == ord("C"):
            is_cpg = g + 1 < n and ref_seq[g + 1] == ord("G")
            meth = is_cpg and meth_state[g]
            if not meth and (rng is None or rng.random() < conv_rate):
                seq[i] = ord("T")
        elif bottom and seq[i] == ord("G"):
            is_cpg = g >= 1 and ref_seq[g - 1] == ord("C")
            meth = is_cpg and meth_state[g - 1]
            if not meth and (rng is None or rng.random() < conv_rate):
                seq[i] = ord("A")
    return bytes(seq)


def simulate_reads(seqs, rng, n_reads=500, read_len=80, paired=True,
                   insert=120, meth_rate=0.6):
    """Simulate reads over {chrom: uint8 seq}. Returns (reads, meth_states)."""
    chroms = list(seqs.keys())
    meth_states = {}
    for c, s in seqs.items():
        meth_states[c] = rng.random(len(s)) < meth_rate
    reads = []
    for r in range(n_reads):
        chrom = chroms[rng.integers(len(chroms))]
        ref = seqs[chrom]
        bottom = bool(rng.integers(2))
        qname = f"read{r:06d}"
        if paired:
            max_start = len(ref) - (read_len + insert + read_len) - 2
            if max_start <= 1:
                continue
            p1 = int(rng.integers(0, max_start))
            gap = int(rng.integers(-read_len // 2, insert))
            p2 = p1 + read_len + gap
            s1 = bisulfite_seq(ref, p1, read_len, meth_states[chrom], bottom)
            s2 = bisulfite_seq(ref, p2, read_len, meth_states[chrom], bottom)
            if bottom:
                f1, f2 = 83, 163  # read1 reverse / read2 forward (OB pair)
                # positions: read1 is rightmost conventionally, but patter
                # only uses flags; keep p1<p2 with these flags
            else:
                f1, f2 = 99, 147
            reads.append(SimRead(qname, f1, chrom, p1, s1, f"{read_len}M"))
            reads.append(SimRead(qname, f2, chrom, p2, s2, f"{read_len}M"))
        else:
            max_start = len(ref) - read_len - 2
            p = int(rng.integers(0, max_start))
            s = bisulfite_seq(ref, p, read_len, meth_states[chrom], bottom)
            reads.append(
                SimRead(qname, 16 if bottom else 0, chrom, p, s,
                        f"{read_len}M")
            )
    return reads, meth_states


def add_cigar_variants(reads, seqs, rng, frac=0.1):
    """Mutate a fraction of reads to exercise S/I/D CIGAR paths."""
    for rd in reads:
        if rng.random() > frac:
            continue
        choice = rng.integers(3)
        seq = bytearray(rd.seq)
        L = len(seq)
        if choice == 0:  # soft clip 5 head bases (aligned portion shifts)
            rd.cigar_str = f"5S{L - 5}M"
            # seq stays; aligned portion = seq[5:], so pos stays -> the
            # aligned reference starts at pos and matches seq[5:]
            ref = seqs[rd.chrom]
            head = bytes(5 * b"A")
            rd.seq = head + rd.seq[: L - 5]
        elif choice == 1:  # insertion of 3 bases at offset 10
            rd.cigar_str = f"10M3I{L - 13}M"
            rd.seq = rd.seq[:10] + b"AAA" + rd.seq[10 : L - 3]
        else:  # deletion of 2 bases at offset 10
            rd.cigar_str = f"10M2D{L - 10}M"
    return reads


def dump_sam(reads, seqs, path):
    """Position-sorted SAM text (as `samtools view` would emit)."""
    order = sorted(range(len(reads)), key=lambda i: (reads[i].chrom,
                                                     reads[i].pos0))
    with open(path, "w") as f:
        for i in order:
            f.write(reads[i].sam_line() + "\n")
    return path


def dump_bam(reads, seqs, path):
    ref_names = list(seqs.keys())
    ref_lengths = [len(s) for s in seqs.values()]
    order = sorted(range(len(reads)), key=lambda i: (ref_names.index(reads[i].chrom),
                                                     reads[i].pos0))
    # mate coordinates (RNEXT/PNEXT) as an aligner would emit them — the
    # streaming bam2pat path uses them to retire mate-lost singles
    mate_of = {}
    for i, rd in enumerate(reads):
        if rd.flag & 1:
            other = mate_of.setdefault(rd.qname, [])
            other.append(i)
    records = []
    for i in order:
        rd = reads[i]
        qual = b"" if rd.qual is None else bytes(
            q - 33 for q in rd.qual.encode())
        rec = BamRecord(rd.qname, rd.flag, ref_names.index(rd.chrom), rd.pos0,
                        rd.mapq, rd.cigar_list(), rd.seq, qual, b"")
        mates = mate_of.get(rd.qname, ())
        if len(mates) == 2:
            m = reads[mates[1] if mates[0] == i else mates[0]]
            rec.next_ref_id = ref_names.index(m.chrom)
            rec.next_pos = m.pos0
        records.append(rec)
    write_bam(path, ref_names, ref_lengths, records)
    return path


def simulate_bam_pairs(seqs, rng, n_pairs, path, read_len=80, insert=120,
                       meth_rate=0.6):
    """Vectorized paired-end bisulfite BAM: `n_pairs` all-match read pairs
    with the layout of simulate_reads (top pairs flagged 99/147, bottom
    pairs 83/163, full conversion), built as one fixed-width record array
    and written with the native BGZF compressor. For BAMs of hundreds of
    thousands of reads, where the per-base loops above are too slow."""
    import struct

    from wgbs_tools_tpu.formats.bgzf import _BGZF_EOF
    from wgbs_tools_tpu.native import bgzf_compress_native

    names = list(seqs)
    sizes = np.array([len(seqs[c]) for c in names], dtype=np.int64)
    chrom = np.sort(rng.integers(0, len(names), size=n_pairs))
    span = 2 * read_len + insert + 2
    p1 = (rng.random(n_pairs) * (sizes[chrom] - span)).astype(np.int64)
    p2 = p1 + read_len + rng.integers(-read_len // 2, insert, size=n_pairs)
    bottom = rng.integers(0, 2, size=n_pairs).astype(bool)
    pos = np.concatenate([p1, p2])
    ref_id = np.concatenate([chrom, chrom])
    bot = np.concatenate([bottom, bottom])
    mate = np.concatenate([p2, p1])
    flag = np.where(bot, np.concatenate([np.full(n_pairs, 83),
                                         np.full(n_pairs, 163)]),
                    np.concatenate([np.full(n_pairs, 99),
                                    np.full(n_pairs, 147)]))
    pair = np.concatenate([np.arange(n_pairs), np.arange(n_pairs)])
    order = np.lexsort((pos, ref_id))
    pos, ref_id, bot, mate, flag, pair = (a[order] for a in
                                          (pos, ref_id, bot, mate, flag,
                                           pair))
    n = pos.shape[0]
    cols = np.arange(read_len)
    seq = np.empty((n, read_len), np.uint8)
    for c, name in enumerate(names):
        ref = np.asarray(seqs[name], dtype=np.uint8)
        meth = rng.random(ref.shape[0]) < meth_rate
        rows = np.flatnonzero(ref_id == c)
        g = pos[rows, None] + cols[None, :]
        s = ref[g]
        nxt = ref[np.minimum(g + 1, ref.shape[0] - 1)]
        prv = ref[np.maximum(g - 1, 0)]
        top = ~bot[rows, None]
        # top strand: unmethylated C -> T; bottom: unmethylated G -> A
        to_t = top & (s == ord("C")) & ~((nxt == ord("G")) & meth[g])
        to_a = ~top & (s == ord("G")) & ~((prv == ord("C"))
                                          & meth[np.maximum(g - 1, 0)])
        s = np.where(to_t, ord("T"), np.where(to_a, ord("A"), s))
        seq[rows] = s
    enc = np.zeros(256, np.uint8)
    for ch, v in zip(b"=ACMGRSVTWYHKDBN", range(16)):
        enc[ch] = v
    e = enc[seq]
    packed = (e[:, 0::2] << 4) | e[:, 1::2]
    lq = 12  # "r%010d" + NUL
    rec = np.dtype([("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"),
                    ("lrn", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                    ("ncig", "<u2"), ("flag", "<u2"), ("lseq", "<i4"),
                    ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4"),
                    ("name", f"S{lq}"), ("cigar", "<u4"),
                    ("seq", "u1", (read_len // 2,)),
                    ("qual", "u1", (read_len,))])
    arr = np.zeros(n, rec)
    arr["bs"] = rec.itemsize - 4
    arr["ref"] = ref_id
    arr["pos"] = pos
    arr["lrn"] = lq
    arr["mapq"] = 60
    arr["ncig"] = 1
    arr["flag"] = flag
    arr["lseq"] = read_len
    arr["nref"] = ref_id
    arr["npos"] = mate
    arr["name"] = np.char.mod("r%010d", pair).astype(f"S{lq - 1}")
    arr["cigar"] = read_len << 4  # <read_len>M
    arr["seq"] = packed
    arr["qual"] = 0xFF
    header = b"".join(f"@SQ\tSN:{c}\tLN:{l}\n".encode()
                      for c, l in zip(names, sizes))
    head = b"BAM\x01" + struct.pack("<i", len(header)) + header \
        + struct.pack("<i", len(names))
    for c, l in zip(names, sizes):
        nb = c.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
    comp = bgzf_compress_native(head + arr.tobytes())
    if comp is None:
        raise RuntimeError("native BGZF compressor unavailable")
    if not comp.endswith(_BGZF_EOF):
        comp += _BGZF_EOF
    with open(path, "wb") as f:
        f.write(comp)
    return path
