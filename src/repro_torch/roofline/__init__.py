"""Roofline terms of a rank's program on a machine model (`analysis`), the
re-derivation of stored dry-run records (`rederive`) and the bytes and
operations of the step's kernels (`kernels`)."""
