"""Traffic kinds: ``<kind>.run(ctx) -> harness.Run``, one module each.

A cell names its kind and the kind's parameters in ``cells/<cell>.json``;
a new cell of an existing kind is a data file and nothing else.
"""
