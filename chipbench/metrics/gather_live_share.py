"""KV entries the chunk calls' attention masks in over the entries it
gathers (every row's whole page table), every layer of every chunk call
of the run: ``attn.kv_live`` (the backend's host lengths) over
``attn.kv_gathered`` (the gathered tensor's shape)."""
from chipbench.harness.work import ratio


def read(rec):
    return ratio("attn.kv_live", "attn.kv_gathered")
