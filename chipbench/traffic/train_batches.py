"""Training batches: rows of uniformly random token ids, drawn on the
device from the run seed, one batch per step, every row different."""
from __future__ import annotations

import torch

#: token ids are drawn from [FIRST_TOKEN, vocab)
FIRST_TOKEN = 4


class Batches:
    """``next()`` -> {"tokens", "labels", "loss_mask"} of ``batch`` rows
    of ``seq`` tokens; ``labels[t]`` is the token after ``tokens[t]``."""

    def __init__(self, params: dict, seed: int, vocab: int, device):
        self.batch = int(params["batch"])
        self.seq = int(params["seq"])
        self.vocab = int(vocab)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            (int(seed) * 1_000_003 + 17) % (1 << 63))

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def next(self) -> dict:
        ids = torch.randint(FIRST_TOKEN, self.vocab,
                            (self.batch, self.seq + 1),
                            generator=self.gen, device=self.device)
        return {"tokens": ids[:, :-1].contiguous(),
                "labels": ids[:, 1:].contiguous(),
                "loss_mask": torch.ones((self.batch, self.seq),
                                        dtype=torch.float32,
                                        device=self.device)}
