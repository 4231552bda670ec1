"""The benchmark's harness: the generic drivers of a cell (`train`,
`predict`), the yardstick (frozen FLOP model, kernel work counts, profiler
categories, input generators, timing) and the reading of traces and spans.
Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lives in files of its own under perfbench/configs, traffic,
metrics and limits, found by the names in BENCHMARK.json."""
