"""Host syncs a traced step (portbench.tracing.SYNC_CALLS) outside every
``csvit.sync.*`` span of the program: those the program does not name
(portbench.spans)."""

from portbench.spans import unnamed_syncs


def read(t):
    return unnamed_syncs(t)
