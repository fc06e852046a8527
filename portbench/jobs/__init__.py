"""One job of each command through the entry point its CLI calls: a module
here is named after a traffic's ``command`` and has ``run(inputs, cfg,
traffic, sink, stats, device) -> exit code`` and ``SPANS``, the calls into
the program's layers that a traced run wraps in spans of the harness's own
(``trace.spans``), named as PERF.md's layers name them."""
