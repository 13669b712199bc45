"""Golly RLE parsing/printing (numpy; counterpart of
:mod:`lifeapi_tpu.core.rle`) — the universal serialization and debugging
format (reference Parsing.hpp:8-204, LifeAPI.hpp:1101-1171, :1256-1282).

RLE is host-side I/O in numpy; only :func:`parse` and :func:`to_rle` touch
torch boards.  The writer is centered like the reference's ``GenericRLE``
(Parsing.hpp:14-18): the emitted grid covers coordinates x, y in [-32, 32),
i.e. cell char (i, j) of the output is the board cell
``((i + 32) % 64, (j + 32) % 64)``.

The parser implements the *intended* semantics: a bare ``$`` advances one
row (Parsing.hpp:162-164).  The reference's constexpr ``ConstantParse``
drops bare-``$`` advances (LifeAPI.hpp:1147-1152) — a verified snapshot bug
(SURVEY.md section 2.7) that we deliberately do not reproduce.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from .board import from_dense, to_dense

N = 64


def parse_cells(rle):
    """Parse an RLE body into a list of (char, x, y) with origin (0, 0) at
    the top-left, reference ``GenericParse`` semantics (Parsing.hpp:143-190):
    header lines starting with 'x' are skipped, runs accumulate, '$' advances
    rows (default 1), '!' terminates, 'b' and '.' are blanks."""
    body = "".join(
        line for line in rle.splitlines() if not line.strip().startswith("x")
    )
    cells = []
    cnt = 0
    x = 0
    y = 0
    for ch in body:
        if ch.isdigit():
            cnt = cnt * 10 + int(ch)
        elif ch == "$":
            y += cnt if cnt else 1
            x = 0
            cnt = 0
        elif ch == "!":
            break
        elif ch in "\r\n\t ":
            continue
        else:
            n = cnt if cnt else 1
            if ch not in ("b", "."):
                for _ in range(n):
                    cells.append((ch, x, y))
                    x += 1
            else:
                x += n
            cnt = 0
    return cells


def parse_dense(rle, charmap=None):
    """Parse RLE into a dense bool grid [64, 64] indexed [x, y] (or, with
    ``charmap``, a dict of named bool planes).

    charmap: dict char -> tuple of plane names that the char sets, e.g.
    LifeHistory's {'A': ('state',), 'C': ('state', 'marked'), ...}
    (reference LifeHistory.hpp:70-92)."""
    cells = parse_cells(rle)
    if charmap is None:
        grid = np.zeros((N, N), dtype=bool)
        for ch, x, y in cells:
            if ch == "o":
                grid[x % N, y % N] = True
        return grid
    planes = {}
    for ch, x, y in cells:
        for name in charmap.get(ch, ()):
            planes.setdefault(name, np.zeros((N, N), dtype=bool))
            planes[name][x % N, y % N] = True
    return planes


def write_rle_grid(chargrid, flush_trailing=False):
    """Write a char grid [64, 64] (indexed [x, y], already in board coords)
    as centered RLE, reference ``GenericRLE`` semantics (Parsing.hpp:8-66).
    '.' and 'b' are treated as blanks."""
    out = []
    eol_count = 0
    for j in range(N):
        yy = (j + 32) % N
        last_val = chargrid[32 % N][yy]
        run_count = 0
        for i in range(N):
            val = chargrid[(i + 32) % N][yy]
            if val not in (".", "b") and eol_count > 0:
                if eol_count > 1:
                    out.append(str(eol_count))
                out.append("$")
                eol_count = 0
            if val != last_val:
                if run_count > 1:
                    out.append(str(run_count))
                out.append(last_val)
                run_count = 0
            run_count += 1
            last_val = val
        if last_val not in (".", "b"):
            if run_count > 1:
                out.append(str(run_count))
            out.append(last_val)
        eol_count += 1
    if flush_trailing and eol_count > 0:
        if eol_count > 1:
            out.append(str(eol_count))
        out.append("$")
    out.append("!")
    return "".join(out)


def _dense_to_chargrid(dense, on_char="o", off_char="b"):
    return [
        [on_char if dense[x, y] else off_char for y in range(N)] for x in range(N)
    ]


def write_rle(dense):
    """Plain-Life RLE of a dense bool grid (reference ``LifeState::RLE``,
    Parsing.hpp:200-204)."""
    return write_rle_grid(_dense_to_chargrid(np.asarray(dense)))


def write_rle_planes(char_fn):
    """RLE from a function (x, y) -> char, for overlay types."""
    grid = [[char_fn(x, y) for y in range(N)] for x in range(N)]
    return write_rle_grid(grid)


def row_rle(denses, spacing=70):
    """Multi-pattern contact-sheet RLE at fixed spacing (reference
    ``RowRLE``, Parsing.hpp:68-140)."""
    out = []
    run_count = 0
    eol_count = 0
    for j in range(spacing):
        if j < N:
            last_val = bool(denses[0][(0 - N // 2) % N, (j - 32) % N])
        else:
            last_val = False
        run_count = 0
        for pat in denses:
            for i in range(spacing):
                val = False
                if i < N and j < N:
                    val = bool(pat[(i - N // 2) % N, (j - 32) % N])
                if val and eol_count > 0:
                    if eol_count > 1:
                        out.append(str(eol_count))
                    out.append("$")
                    eol_count = 0
                if val != last_val:
                    if run_count > 1:
                        out.append(str(run_count))
                    out.append("o" if last_val else "b")
                    run_count = 0
                run_count += 1
                last_val = val
        if last_val:
            if run_count > 1:
                out.append(str(run_count))
            out.append("o")
            run_count = 0
        eol_count += 1
    if eol_count > 0:
        if eol_count > 1:
            out.append(str(eol_count))
        out.append("$")
    return "".join(out)


def parse(rle_str, device=None):
    """RLE -> int64 board (reference ``LifeState::Parse``,
    Parsing.hpp:192-198)."""
    return from_dense(torch.from_numpy(parse_dense(rle_str)).to(resolve(device)))


def to_rle(board):
    """int64 board -> centered RLE (reference ``LifeState::RLE``,
    Parsing.hpp:200-204).  Note parse(to_rle(b)) == move(b, -32, -32), as in
    the reference (the writer is centered, the parser is origin-based)."""
    return write_rle(to_dense(board).cpu().numpy())


def format_grid(dense):
    """ASCII debugging grid with every-10 rulings, like the reference
    ``Print`` (LifeAPI.hpp:1256-1282).  Row j of the output is y = j - 32,
    column i is x = i - 32."""
    dense = np.asarray(dense)
    lines = []
    for j in range(N):
        row = []
        for i in range(N):
            if dense[(i - N // 2) % N, (j - 32) % N]:
                row.append("O")
            else:
                hor = (j - 32) % 10 == 0
                ver = (i - N // 2) % 10 == 0
                row.append("+" if hor and ver else "-" if hor else "|" if ver else ".")
        lines.append("".join(row))
    return "\n".join(lines)
