"""SAM header construction (create_sam_header, parallel_aux.c:1846-1918)."""

from __future__ import annotations

from typing import List, Optional

VERSION = "1.5.5"  # reference release (configure.ac:3); kept for header parity


def bwa_set_rg(rg: str):
    """bwa_set_rg (bwa.c:431-462): validate -R line, return (line, rg_id).

    Literal "\\t" sequences become tabs; the ID: field is extracted."""
    if not rg.startswith("@RG"):
        raise ValueError("the read group line is not started with @RG")
    line = rg.replace("\\t", "\t")
    p = line.find("\tID:")
    if p < 0:
        raise ValueError("no ID within the read group line")
    p += 4
    q = line.find("\t", p)
    rg_id = line[p:] if q < 0 else line[p:q]
    return line, rg_id


def insert_header(line: str, existing: Optional[str]) -> str:
    """bwa_insert_header (bwa.c:464-474): append a header line."""
    if not line or line[0] != "@":
        raise ValueError("header lines must start with @")
    return line if existing is None else existing + "\n" + line


def make_pg_line(argv: List[str]) -> str:
    """@PG line synthesized from argv (mainParallel.c:282-286)."""
    return "@PG\tID:bwa\tPN:bwa\tVN:" + VERSION + "\tCL:" + " ".join(argv)


def sam_header(anns, hdr_line: Optional[str] = None,
               rg_line: Optional[str] = None,
               pg_line: Optional[str] = None) -> str:
    """@SQ lines + optional -H header lines + -R read group + @PG."""
    parts = [f"@SQ\tSN:{a.name}\tLN:{a.length}\n" for a in anns]
    if hdr_line:
        parts.append(hdr_line + "\n")
    if rg_line:
        parts.append(rg_line + "\n")
    if pg_line:
        parts.append(pg_line + "\n")
    return "".join(parts)


def sam_header_by_chr(ann, hdr_line=None, rg_line=None, pg_line=None,
                      all_anns=None) -> str:
    """Per-chromosome output headers: each file carries the FULL @SQ set
    (create_sam_header_by_chr_file, parallel_aux.c:2677-2687)."""
    return sam_header(all_anns if all_anns is not None else [ann],
                      hdr_line, rg_line, pg_line)
