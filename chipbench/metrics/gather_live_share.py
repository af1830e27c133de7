"""KV entries the chunk calls' attention attends over the KV slots it
reads, every layer of every chunk call of the run: ``attn.kv_live``
(the backend's host lengths) over ``attn.kv_gathered`` (on the card the
slots the paged-prefill kernel reads, each prefilling row's live pages;
on the CPU the gathered tensor's shape)."""
from chipbench.harness.work import ratio


def read(rec):
    return ratio("attn.kv_live", "attn.kv_gathered")
