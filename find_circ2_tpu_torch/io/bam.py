"""BAM binary input/output: completes the samtools/pysam replacement
(SURVEY.md §2.2 samtools row; the reference pipeline pipes
`bowtie2 | samtools view -hbf 4` **BAM** into unmapped2anchors.py,
SURVEY.md §3.1 — until now only SAM text was accepted, docs/PARITY.md
"known gaps").

BGZF is a sequence of concatenated gzip members, each carrying a
`BC`-tagged extra subfield with the compressed block size. For pure
sequential reading the extra field is irrelevant — Python's gzip module
consumes concatenated members transparently (virtual-offset seeking,
which needs the BC field, has no use here: the pipeline is one streaming
pass, SURVEY.md §3.5). The writer emits spec-conformant BGZF (BC extra
subfield + the 28-byte EOF sentinel block) so output is readable by
samtools/pysam and by this module alike.

Alignment-record layout per the SAM/BAM spec (all little-endian):
block_size i32 | refID i32 | pos i32 | l_read_name u8 | mapq u8 | bin u16
| n_cigar_op u16 | flag u16 | l_seq u32 | next_refID i32 | next_pos i32 |
tlen i32 | read_name NUL-terminated | cigar u32[n] | seq nibbles | qual.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from collections.abc import Iterable, Iterator

from find_circ2_tpu_torch.io.sam import SamRecord

SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIBBLE_OF = {c: i for i, c in enumerate(SEQ_NIBBLE)}
_MAGIC = b"BAM\x01"
# Fixed-size head of an alignment record, after block_size.
_REC_HEAD = struct.Struct("<iiBBHHHIiii")
# Spec-mandated BGZF EOF marker: an empty deflate block as a member.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# ---------------------------------------------------------------- reading

def read_bam(path: str | os.PathLike) -> Iterator[SamRecord]:
    """Yield every alignment record of a BAM file as a SamRecord
    (name/flag/seq/qual — the fields the pipeline consumes; positions
    are re-derived by our own aligner so refID/pos/cigar are skipped)."""
    with gzip.open(path, "rb") as fh:
        if fh.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", fh.read(4))
        fh.read(l_text)                       # header text (unused)
        (n_ref,) = struct.unpack("<i", fh.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            fh.read(l_name + 4)               # name + l_ref
        while True:
            raw = fh.read(4)
            if len(raw) < 4:
                return                        # clean EOF
            (block_size,) = struct.unpack("<i", raw)
            body = fh.read(block_size)
            if len(body) != block_size:
                raise ValueError(f"{path}: truncated BAM record")
            (_refid, _pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _nrefid, _npos, _tlen) = _REC_HEAD.unpack_from(body)
            off = _REC_HEAD.size
            name = body[off:off + l_read_name - 1].decode("ascii")
            off += l_read_name + 4 * n_cigar
            nbytes = (l_seq + 1) // 2
            seq_raw = body[off:off + nbytes]
            off += nbytes
            qual_raw = body[off:off + l_seq]
            seq = "".join(
                SEQ_NIBBLE[(seq_raw[i >> 1] >> (4 if i % 2 == 0 else 0))
                           & 0xF]
                for i in range(l_seq))
            qual = ("" if l_seq == 0 or qual_raw[0:1] == b"\xff"
                    else "".join(chr(q + 33) for q in qual_raw))
            yield SamRecord(name=name, flag=flag, seq=seq or "*",
                            qual=qual)


def reads_from_bam(path: str | os.PathLike, unmapped_only: bool = True
                   ) -> Iterator[tuple[str, str, str, bool]]:
    """(name, seq, qual, mate2) original reads — identical selection and
    orientation semantics as io.sam.reads_from_sam (one shared filter)."""
    from find_circ2_tpu_torch.io.sam import original_reads
    return original_reads(read_bam(path), unmapped_only)


def sniff_format(path: str | os.PathLike) -> str:
    """'bam' | 'sam' | 'fastq' by content: BAM = gzip member whose
    payload starts with the BAM magic; else gz/text sniffed on the first
    byte ('@' alone is ambiguous between SAM headers and FASTQ, so SAM is
    detected by tab-separated 11+ field lines after headers)."""
    path = os.fspath(path)
    with open(path, "rb") as raw:
        head = raw.read(4)
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as fh:
            if fh.read(4) == _MAGIC:
                return "bam"
            fh.seek(0)
            return _sniff_text(fh.read(65536))
    with open(path, "rb") as fh:
        return _sniff_text(fh.read(65536))


def _sniff_text(buf: bytes) -> str:
    for line in buf.decode("ascii", "replace").splitlines():
        if not line:
            continue
        if line.startswith(("@HD\t", "@SQ\t", "@RG\t", "@PG\t", "@CO\t")):
            return "sam"                    # unambiguous SAM header
        if line.startswith("@"):
            continue                        # FASTQ title / other header
        # First non-'@' line: a SAM record has >= 11 tab-separated
        # fields; a FASTQ sequence/qual line has no tabs.
        return "sam" if line.count("\t") >= 10 else "fastq"
    return "fastq"


# ---------------------------------------------------------------- writing

def _bgzf_block(payload: bytes) -> bytes:
    """One spec-conformant BGZF member (gzip + BC extra subfield)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = co.compress(payload) + co.flush()
    bsize = len(data) + 25          # header(18) + crc(4) + isize(4) - 1
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize)
            + data
            + struct.pack("<II", zlib.crc32(payload),
                          len(payload) & 0xFFFFFFFF))


def write_bam(path: str | os.PathLike, records: Iterable[SamRecord],
              refs: Iterable[tuple[str, int]] = (),
              header_text: str = "") -> int:
    """Write records as BAM (unmapped-style: refID/pos = -1, no cigar —
    exactly what the reference's `samtools view -bf 4` stage carries).
    Returns the number of records written."""
    head = bytearray()
    text = header_text.encode("ascii")
    head += _MAGIC + struct.pack("<i", len(text)) + text
    refs = list(refs)
    head += struct.pack("<i", len(refs))
    for name, length in refs:
        nb = name.encode("ascii") + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)

    n = 0
    with open(path, "wb") as out:
        buf = bytearray(head)
        for rec in records:
            seq = "" if rec.seq == "*" else rec.seq
            nb = rec.name.encode("ascii") + b"\x00"
            body = _REC_HEAD.pack(-1, -1, len(nb), 0, 4680, 0, rec.flag,
                                  len(seq), -1, -1, 0) + nb
            packed = bytearray((len(seq) + 1) // 2)
            for i, c in enumerate(seq):
                v = _NIBBLE_OF.get(c.upper(), 15)
                packed[i >> 1] |= v << (4 if i % 2 == 0 else 0)
            body += bytes(packed)
            body += (b"\xff" * len(seq) if not rec.qual
                     else bytes(ord(q) - 33 for q in rec.qual))
            buf += struct.pack("<i", len(body)) + body
            n += 1
            while len(buf) >= 60000:
                out.write(_bgzf_block(bytes(buf[:60000])))
                del buf[:60000]
        if buf:
            out.write(_bgzf_block(bytes(buf)))
        out.write(BGZF_EOF)
    return n
