"""Faults planted under a training step, for the checks that must fail
them: a step that returns its state unchanged, and one that leaves half
of each batch out (the mean taken over the rest)."""


def unchanged(step):
    def run(params, opt, batch):
        _, _, m = step(params, opt, batch)
        return params, opt, m
    return run


def half_batch(step):
    def run(params, opt, batch):
        half = batch["tokens"].shape[0] // 2
        return step(params, opt, {k: v[:half] for k, v in batch.items()})
    return run
