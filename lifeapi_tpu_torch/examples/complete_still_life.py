"""Still-life completion: reconstruct an eater from partial information
with the host DFS (the reference's CompleteStable workflow; the port of
``examples/complete_still_life.py``).

    python -m lifeapi_tpu_torch.examples.complete_still_life [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import board, rle
from ..stable import complete, host
from . import life_step_dense, resolve_device

EATER_RLE = "2b2o$bobo$bo$2o!"


def run(device, timeout=5.0):
    """Forget two cells of an eater at (20, 20) and complete the rest with
    the minimising host DFS.  The board is built on ``device``; the DFS
    runs on the host.  Returns a dict with the verdict, the completion and
    an independent numpy check that it is a still life."""
    eater = board.to_dense(board.move(rle.parse(EATER_RLE, device=torch.device(device)),
                                      20, 20)).cpu().numpy()
    hide = np.zeros((64, 64), dtype=bool)
    hide[20:22, 20] = True  # forget two cells
    result, best = complete.complete_stable(host.HostStable(eater & ~hide, hide),
                                            timeout=timeout, minimise=True)
    return {"result": result, "best": best, "eater": bool((best == eater).all()),
            "still_life": bool((life_step_dense(best) == best).all())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device))
    print(r["result"])
    print(rle.write_rle(r["best"]))


if __name__ == "__main__":
    main()
