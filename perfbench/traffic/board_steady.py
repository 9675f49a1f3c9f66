"""Traffic kind ``board_steady``: one big board advanced for the whole
window, as a long simulation runs.

The mix gives ``height``, ``width``, ``density`` (the share of live cells
or up spins the board starts with), ``chunk_steps`` (the steps of one
advance, each followed by a sync) and ``setup_steps`` (the steps run in
set-up, in chunks; the first chunk's board is checked).  The configuration
gives the rule, the backend, the Runner's keywords, the reference and the
name of the rate it reports.

Set-up draws the board from the seed, stages it through the program's
``make_runner`` and runs ``setup_steps``.  The window advances chunk after
chunk until ``--seconds`` have passed at a sync; its rate is the cells
times the steps done by the last sync over the window.  The window copies
the board before each chunk (``Runner.snapshot``) so that the reference
can follow the window's last chunk from the program's own state, since
following the whole window would take it hours; the first chunk of set-up
is followed from the seed's board.  Both are compared cell by cell.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, inputs
from perfbench.reference import mismatches


class ReferenceRunner:
    """The configuration's reference with a broken guarantee
    (``control_advance``) in the program's place: the control."""

    def __init__(self, ref, board: np.ndarray, device: torch.device, seed: int, args: dict):
        self.ref, self.seed, self.args = ref, seed, args
        self.board = torch.from_numpy(board).to(device)
        self.step = 0

    def advance(self, steps: int) -> None:
        self.board = self.ref.control_advance(self.board, steps, seed=self.seed,
                                              start=self.step, **self.args)
        self.step += steps

    def sync(self) -> None:
        if self.board.is_cuda:
            torch.cuda.synchronize(self.board.device)

    def fetch(self) -> np.ndarray:
        return self.board.cpu().numpy()

    def snapshot(self):
        return lambda board=self.board: board.cpu().numpy()


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    h, w, chunk = mix["height"], mix["width"], mix["chunk_steps"]
    ref = harness.reference(ctx.cell)
    ref_args = cfg["reference"].get("args", {})
    board0 = inputs.boards(ctx.seed, 1, h, w, mix["density"], ctx.device)[0].cpu().numpy()

    if ctx.control:
        runner = ReferenceRunner(ref, board0, ctx.device, ctx.seed, ref_args)
    else:
        from tpu_life_torch.backends.base import get_backend, make_runner
        from tpu_life_torch.models.rules import get_rule

        backend = get_backend(cfg["backend"], device=str(ctx.device))
        with ctx.span("stage"):
            runner = make_runner(backend, board0, get_rule(cfg["rule"]), seed=ctx.seed,
                                 **cfg.get("runner", {}))
    done, first = 0, None
    while done < mix["setup_steps"]:
        n = min(chunk, mix["setup_steps"] - done)
        runner.advance(n)
        runner.sync()
        done += n
        if first is None:  # to the host, so the window holds no copy of it
            first = (n, runner.fetch())

    chunks = 0
    with ctx.window():
        t0 = time.perf_counter()
        while True:
            with ctx.span("snapshot"):
                before = None  # one copy of the board on the device at a time
                before = runner.snapshot()
            with ctx.span("advance"):
                runner.advance(chunk)
            with ctx.span("sync"):
                runner.sync()
            chunks += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= ctx.seconds:
                break
    last_start = done + (chunks - 1) * chunk
    final = runner.fetch()
    board_before = before()
    start_steps, start_board = first
    del runner, before, first
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    def follow(board: np.ndarray, steps: int, start: int) -> np.ndarray:
        out = ref.advance(torch.from_numpy(board).to(ctx.device), steps, seed=ctx.seed,
                          start=start, **ref_args)
        return out.cpu().numpy()

    checks = [
        harness.Check("start_cells_differing",
                      mismatches(follow(board0, start_steps, 0), start_board), 0),
        harness.Check("end_cells_differing",
                      mismatches(follow(board_before, chunk, last_start), final), 0),
    ]
    steps = chunks * chunk
    return harness.Outcome(
        end_to_end={cfg["rate_metric"]: h * w * steps / elapsed},
        checks=checks, attempted=chunks, failed=0,
        work={"height": h, "width": w, "steps": steps, "chunks": chunks,
              "board": board_before},
    )
