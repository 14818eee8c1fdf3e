"""The harness: cells, loops, trace, check and the run itself."""
