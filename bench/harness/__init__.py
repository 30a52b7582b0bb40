"""The benchmark's harness: cells found by name, the loop, timing, the check."""
