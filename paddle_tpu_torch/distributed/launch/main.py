"""Entry: ``python -m paddle_tpu_torch.distributed.launch [opts] train.py
...`` — counterpart of ``paddle_tpu/distributed/launch/main.py``."""

from __future__ import annotations

import logging
import signal
import sys
from typing import List, Optional

from .context import Context
from .controller import CollectiveController


def launch(argv: Optional[List[str]] = None) -> int:
    """Run the job ``argv`` describes (the command line without the
    program name; ``sys.argv[1:]`` when None); returns the exit code:
    0 when every trainer finished, 1 when the job failed."""
    ctx = Context(argv)
    logging.basicConfig(
        level=getattr(logging, ctx.args.log_level.upper(), logging.INFO),
        format="LAUNCH %(levelname)s %(asctime)s %(message)s")
    ctrl = CollectiveController(ctx)

    def _sig(_signum, _frame):
        ctrl.stop()
        sys.exit(130)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    return ctrl.run()


def main() -> None:
    sys.exit(launch())


if __name__ == "__main__":
    main()
