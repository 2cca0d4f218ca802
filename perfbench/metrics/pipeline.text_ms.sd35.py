"""Mean time per preview request (``serve.request``) of the three text towers: the program's
``text.clip_l``, ``text.clip_g`` and ``text.t5`` spans, host time to each tower's return
(program spans).  A program without these spans reads nothing."""

from perfbench.lib.spans import mean_ms

TOWERS = ("text.clip_l", "text.clip_g", "text.t5")


def read(rec):
    return mean_ms(rec, TOWERS, "serve.request")
