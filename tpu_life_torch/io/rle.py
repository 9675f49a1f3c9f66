"""Run-length-encoded (RLE) pattern interchange.

A copy of ``tpu_life/io/rle.py`` (``parse_rle``, ``emit_rle``), with the
same results and error messages, so ``python -m tpu_life_torch pattern``
writes the bytes ``python -m tpu_life pattern`` writes.  RLE is the
cellular-automaton ecosystem's pattern format (``x = W, y = H, rule =
B3/S23`` header; ``b``/``o`` dead/live run tokens, ``$`` row advance,
``!`` terminator, ``#`` comment lines); the contract codec
(``tpu_life_torch/io/codec.py``) reads and writes the boards.

Both standard dialects are supported: two-state (``b``/``o``) and the
multi-state Generations alphabet (``.`` dead, ``A``..``X`` states 1..24).
States above 24 (the ``p``..``y`` prefix-pair extension) are rejected.
"""

from __future__ import annotations

import re

import numpy as np


def parse_rle(text: str) -> tuple[np.ndarray, dict]:
    """RLE text -> (int8 board, meta).

    ``meta`` carries ``rule`` (the header's rule string, if any) and
    ``comments`` (the ``#``-line bodies).  The header's x/y are authoritative
    when present (rows are padded with dead cells to x, and the row count to
    y); without a header the bounding box of the encoded cells is used.
    """
    height = width = None
    rule = None
    comments: list[str] = []
    rows: list[list[int]] = []
    cur: list[int] = []
    count = 0
    done = False
    saw_header = False
    for line in text.splitlines():
        s = line.strip()
        if not s:
            continue
        if s.startswith("#"):
            comments.append(s[1:].strip())
            continue
        # header sniff: 'X' is also a body token (state 24), so only a
        # first line containing '=' is treated as a header candidate
        if not saw_header and not rows and not cur and s[:1] in "xX" and "=" in s:
            # the rule value may itself contain commas (Golly LtL specs like
            # R5,C2,S34..58,B34..45), so it must be matched as "rest of
            # line", never comma-split
            m = re.match(
                r"x\s*=\s*(\d+)\s*,\s*y\s*=\s*(\d+)"
                r"(?:\s*,\s*rule\s*=\s*(.+?))?\s*$",
                s,
                re.IGNORECASE,
            )
            if m is None:
                raise ValueError(f"malformed RLE header {s!r}")
            width, height = int(m.group(1)), int(m.group(2))
            rule = m.group(3)
            saw_header = True
            continue
        for ch in s:
            if done:
                break
            if ch.isdigit():
                count = count * 10 + int(ch)
            elif ch in "b.":
                cur.extend([0] * max(1, count))
                count = 0
            elif ch == "o":
                cur.extend([1] * max(1, count))
                count = 0
            elif "A" <= ch <= "X":
                # multi-state Generations alphabet: 'A' = state 1 (== live)
                # through 'X' = state 24
                cur.extend([ord(ch) - 64] * max(1, count))
                count = 0
            elif ch == "$":
                n = max(1, count)
                count = 0
                rows.append(cur)
                cur = []
                rows.extend([] for _ in range(n - 1))
            elif ch == "!":
                done = True
            elif ch.isspace():
                continue
            else:
                raise ValueError(
                    f"unsupported RLE token {ch!r} (b/o and the ./A..X "
                    f"multi-state alphabet are supported; states above 24 "
                    f"are not)"
                )
        if done:
            break
    if cur:
        rows.append(cur)
    w = width if width is not None else max((len(r) for r in rows), default=0)
    h = height if height is not None else len(rows)
    if len(rows) > h or any(len(r) > w for r in rows):
        raise ValueError(
            f"RLE body exceeds its declared extent x={w}, y={h}"
        )
    board = np.zeros((h, w), np.int8)
    for i, r in enumerate(rows):
        if r:
            board[i, : len(r)] = r
    return board, {"rule": rule, "comments": comments}


def emit_rle(
    board: np.ndarray,
    *,
    rule: str | None = "B3/S23",
    states: int = 2,
    comments: tuple[str, ...] = (),
    line_width: int = 70,
) -> str:
    """int8 board -> RLE text (header + wrapped body, trailing newline).

    Two-state boards use the ``b``/``o`` dialect; ``states > 2`` (or any
    cell above 1) switches to the Generations ``.``/``A..X`` alphabet.
    """
    board = np.asarray(board)
    max_state = int(board.max(initial=0))
    multi = states > 2 or max_state > 1
    if max_state > 24:
        raise ValueError(
            "RLE export supports states up to 24 ('X'); this board exceeds it"
        )

    def tag(v: int) -> str:
        if multi:
            return "." if v == 0 else chr(64 + v)
        return "o" if v else "b"

    h, w = board.shape
    row_tokens: list[str] = []
    for r in range(h):
        row = board[r]
        nz = np.flatnonzero(row)
        last = int(nz[-1]) + 1 if nz.size else 0
        if not last:
            row_tokens.append("")
            continue
        seg = row[:last]
        # vectorized run detection: Python work scales with the number of
        # runs, not cells (dense multi-gigacell boards are the contract
        # codec's job, not RLE's)
        bounds = np.flatnonzero(np.diff(seg)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [last]))
        row_tokens.append(
            "".join(
                (str(e - s) if e - s > 1 else "") + tag(int(seg[s]))
                for s, e in zip(starts, ends)
            )
        )
    body = "$".join(row_tokens) + "!"
    # collapse empty-row runs into counted $ and drop trailing dead rows
    body = re.sub(r"\$+", lambda m: (str(len(m.group())) if len(m.group()) > 1 else "") + "$", body)
    body = re.sub(r"(\d+)?\$!", "!", body)
    # wrap on token boundaries (a token = optional count + one tag char)
    tokens = re.findall(r"\d*(?:[bo$!.]|[A-X])", body)
    lines: list[str] = []
    cur_line = ""
    for t in tokens:
        if cur_line and len(cur_line) + len(t) > line_width:
            lines.append(cur_line)
            cur_line = ""
        cur_line += t
    if cur_line:
        lines.append(cur_line)
    header = f"x = {w}, y = {h}" + (f", rule = {rule}" if rule else "")
    out = [f"#C {c}" for c in comments] + [header] + lines
    return "\n".join(out) + "\n"
