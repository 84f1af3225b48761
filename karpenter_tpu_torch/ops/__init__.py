"""Solver ops: encode, host oracle, device solve, consolidation screen."""
