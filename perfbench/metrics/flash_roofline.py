"""flash_roofline: the causal attention's operations and bytes (counted
from shapes) over the device time of every kernel launched under the
flash attention's forward and backward host ops in the captures' traces,
against the card's roofline. Only op instances whose every launch has its
kernel record count."""

from perfbench import counts


def read(run):
    m, t = run.model, run.traffic
    h = m["num_attention_heads"]
    shape = (t["batch"], t["seq_len"], h, m["hidden_size"] // h)
    flops = nbytes = seconds = 0.0
    for c in run.captures:
        facts = c.get("trace")
        if not facts:
            continue
        for key, products, backward in (
                ("flash_fwd", counts.ATTN_FWD_PRODUCTS, False),
                ("flash_bwd", counts.ATTN_BWD_PRODUCTS, True)):
            for inst in facts[key]:
                flops += counts.attention_flops(products, *shape)
                nbytes += counts.attention_bytes(backward, *shape, 2)
                seconds += inst["seconds"]
    if not seconds:
        return None
    return counts.roofline_pct(flops, nbytes, seconds)
