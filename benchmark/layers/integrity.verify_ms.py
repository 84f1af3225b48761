"""Integrity oracle (integrity/oracle.py verify_result, before a solve's result
is committed): the program's span integrity.verify summed over the
window, in ms a request."""

NAMES = ("integrity.verify",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
