"""The benchmark's harness: the command line, the run's life cycle, the
program's entry points, tracing and the result line."""
