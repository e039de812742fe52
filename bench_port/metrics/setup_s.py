"""setup_s: seconds from the process's start to the first timed call
(corpus and id maps, the table on the card, the tower, the pool of
rankings, the warm-up)."""


def read(run):
    return run.setup_s
