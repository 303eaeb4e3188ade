"""csr.program_idle_pct: the share of the traced window in which the card
idled while the innermost host event was one of the program's own spans
(glu.*, the two-word chain's glu.two_word.minor and .major among them)."""

from benchmark import plugins


def read(run):
    return plugins.load("metrics", "_program").idle_pct(run)
