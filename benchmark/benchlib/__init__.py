"""The benchmark's harness: cells, traffic, spans, hooks, rooflines."""
