"""Analysis tools (counterpart of ``repro/analysis``): the roofline at the
H100's data-sheet peaks and profiler-trace scope queries."""
