"""Prompt tokens over the token positions the chunk calls computed
(every row times the chunk, the rows that are not prefilling too), over
every chunk call of the run: the paged backend's counters
``serve.tokens_useful`` / ``serve.tokens_computed``."""
from chipbench.harness.work import ratio


def read(rec):
    return ratio("serve.tokens_useful", "serve.tokens_computed")
