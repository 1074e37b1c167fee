"""The benchmark's metrics, one reader a file: ``<name>.py`` holds
``read(run)``, which takes the metric ``<name>`` of ``BENCHMARK.json`` from
a :class:`benchmark.harness.RunRecord` (the run's clock, its spans, the
solver's counters or the device trace) and returns it in the metric's
unit, or None where the run has nothing to read it from."""
