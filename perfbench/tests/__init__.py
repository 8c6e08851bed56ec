"""CPU tests of the benchmark: the yardstick, the statistics, the span
rule, the result line, the manifest, the imports, the reference against
the port, and the faults a run must catch.  They run on small shapes
and never look for a card."""
