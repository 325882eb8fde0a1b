"""tools/mark_library.sh equivalent: libN_ barcode prefixing.

Rewrites header barcodes x_x_x -> libN_x_x_x so multiple stLFR
libraries don't collide (/root/reference/tools/mark_library.sh:23-27):
only header lines (every 4th) with an awk '#|/'-field barcode that is
not 0_0_0 are rewritten; everything else passes through unchanged.
"""

from __future__ import annotations

import re

from hast_jax.io import fastq as FQ

_SPLIT = re.compile(rb"[#/]")


def mark_library(path: str, lib_id: int, out) -> None:
    with FQ.open_text(path) as f:
        n = 0
        for line in f:
            n += 1
            if n % 4 == 1:
                stripped = line.rstrip(b"\r\n")
                fields = _SPLIT.split(stripped)
                if len(fields) > 1 and fields[1] != b"0_0_0":
                    # awk prints $1#libN_$2/$3 — fields beyond $3 drop,
                    # matching the reference's printf
                    f3 = fields[2] if len(fields) > 2 else b""
                    out.write(b"%s#lib%d_%s/%s\n"
                              % (fields[0], lib_id, fields[1], f3))
                    continue
                out.write(stripped + b"\n")
            else:
                out.write(line)
