"""ssched_sim -- FIFO-baseline simulation CLI (the port's counterpart of
``dmclock_tpu/sim/ssched_sim.py``; ``--device`` as in ``dmc_sim``).

Equivalent of the reference's ``ssched_sim``
(``sim/src/test_ssched_main.cc:49-199``), which runs the same harness
over the simple FIFO queue.  Unlike the reference (hardcoded params),
this accepts the same INI configs as dmc_sim -- and the same
observability flags (``--trace``, ``--conformance``,
``--ledger-check``, ``--metrics-port``, ``--trace-out`` for a
Perfetto span timeline); the FIFO queue materializes no tags and no
ledger, so the tardiness percentiles and ledger cross-check degrade
to their documented no-backend paths.
"""

from __future__ import annotations

import sys

from .dmc_sim import main as _main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return _main(argv + ["--model", "ssched"])


if __name__ == "__main__":
    sys.exit(main())
