"""Process start to the first timed request or step: imports, inputs
from the cache, weights made on the card, service or train state built,
warm-up at the cell's own shapes."""


def read(rec, cell):
    return rec["setup_s"]
