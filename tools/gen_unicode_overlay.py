#!/usr/bin/env python3
"""Generate ``crowdllama_tpu_torch/engine/unicode_overlay.py``.

    python tools/gen_unicode_overlay.py [--check]

The port's ``tokenizer.json`` reader builds Oniguruma's ``\\p{..}``
classes from Python's ``unicodedata`` (Unicode 15.0 on Python 3.12),
while ``tokenizers`` matches them against its own, later tables.  This
script asks ``tokenizers`` itself (the oracle: each general category's
members, found by a ``Split`` pre-tokenizer that removes ``\\p{Xx}`` from
a string of every code point) and writes the code points whose category
there differs from this Python's as ranges, with the version of the
Unicode tables the oracle answered with.  The port reads that file and
needs neither ``tokenizers`` nor ``regex``.  ``--check`` compares the
checked-in file with what the oracle gives now and exits 1 on a
difference.
"""

from __future__ import annotations

import argparse
import sys
import unicodedata
from pathlib import Path

OUT = (Path(__file__).resolve().parents[1] / "crowdllama_tpu_torch" / "engine"
       / "unicode_overlay.py")
CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl",
              "No", "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc",
              "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf", "Co", "Cn")
# Code points added in each Unicode version after 15.0, one of each, by
# which the oracle's version is named (the newest it assigns).
PROBES = (("15.1", 0x2EBF0), ("16.0", 0x13460), ("17.0", 0x10940))


def oracle_categories() -> dict[int, str]:
    """Every code point but the surrogates -> its general category in
    ``tokenizers``' tables."""
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    cps = [c for c in range(sys.maxunicode + 1) if not 0xD800 <= c <= 0xDFFF]
    text = "".join(map(chr, cps))
    out: dict[int, str] = {}
    for cat in CATEGORIES:
        kept = bytearray(len(cps))
        pieces = pt.Split(Regex(rf"\p{{{cat}}}"), "removed").pre_tokenize_str(
            text)
        for _, (a, b) in pieces:
            kept[a:b] = b"\x01" * (b - a)
        for i, k in enumerate(kept):
            if not k:
                if cps[i] in out:
                    raise SystemExit(f"U+{cps[i]:04X} in both \\p{{{out[cps[i]]}}} "
                                     f"and \\p{{{cat}}}")
                out[cps[i]] = cat
    missing = [c for c in cps if c not in out]
    if missing:
        raise SystemExit(f"{len(missing)} code points in no category, e.g. "
                         f"U+{missing[0]:04X}")
    return out


def changed_ranges(oracle: dict[int, str]) -> list[tuple[int, int, str]]:
    rows: list[tuple[int, int, str]] = []
    for cp in sorted(oracle):
        cat = oracle[cp]
        if unicodedata.category(chr(cp)) == cat:
            continue
        if rows and rows[-1][1] == cp - 1 and rows[-1][2] == cat:
            rows[-1] = (rows[-1][0], cp, cat)
        else:
            rows.append((cp, cp, cat))
    return rows


def render(rows, version: str) -> str:
    import tokenizers

    lines = [
        '"""General categories that changed after this Python\'s Unicode',
        "database, as ``tokenizers`` matches ``\\\\p{..}``.",
        "",
        "Generated by ``tools/gen_unicode_overlay.py`` (do not edit) from",
        f"``tokenizers`` {tokenizers.__version__}, whose tables are Unicode "
        f"{version},",
        f"against ``unicodedata`` {unicodedata.unidata_version}.  "
        "``engine/tokenizer_json.py`` overlays",
        "these categories on ``unicodedata``'s when it builds its classes.",
        '"""',
        "",
        f'UNICODE_VERSION = "{version}"',
        "",
        "#: (first, last, category): every code point from first to last has",
        "#: that general category in ``tokenizers``' tables",
        "CHANGED = (",
    ]
    lines += [f'    (0x{a:05X}, 0x{b:05X}, "{c}"),' for a, b, c in rows]
    lines.append(")")
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the checked-in file instead of "
                         "writing it")
    args = ap.parse_args()
    oracle = oracle_categories()
    version = unicodedata.unidata_version
    for v, cp in PROBES:
        if oracle[cp] != "Cn":
            version = v
    text = render(changed_ranges(oracle), version)
    if args.check:
        if OUT.read_text() != text:
            print(f"{OUT} differs from the oracle's tables", file=sys.stderr)
            return 1
        return 0
    OUT.write_text(text)
    print(f"wrote {OUT} (Unicode {version})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
