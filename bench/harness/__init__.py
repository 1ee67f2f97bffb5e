"""The harness: reads ``BENCHMARK.json`` and the files it names, drives the
program's serving engine over a cell's traffic, times it, and judges its
answers against the plain reference."""
