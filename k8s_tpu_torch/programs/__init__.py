"""Workload programs of the port (``KTPU_PROGRAM_ARGS``-configured
entry points with a ``main(rdzv)``)."""
