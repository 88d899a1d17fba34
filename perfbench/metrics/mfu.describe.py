"""The whole serving step's share of the card's bf16 peak: the
benchmark's count of the operations of the prefills and decode steps
that ended in the window (the VLM at each request's real lengths, empty
slots not counted) and of the MEM text tower for the questions embedded
in it, over the window and 989 TFLOP/s."""

from perfbench import counts

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "answer_tokens_per_s"


def read(rec):
    from perfbench.systems.vlm_service import memory_config
    m = rec.cfg
    flops = 0.0
    for st in rec.obs["steps"]:
        if rec.t0 <= st["t0"] and st["t1"] <= rec.t1:
            flops += sum(counts.prefill_flops(m, n) for n in st["prefills"])
            flops += counts.decode_flops(m, st["contexts"])
    mem = memory_config(m)
    flops += counts.mem_text_flops(mem, rec.obs["queries_embedded"])
    return 100.0 * flops / (rec.window_s * counts.PEAK_BF16_FLOPS)
