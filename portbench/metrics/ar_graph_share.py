"""Blocks of the batched AR's decode loop run as replays of one captured
CUDA graph (the program's `seconds["ar_graph_blocks"]`) over the blocks
run (decode steps / K), over the untraced batches, in %: 100 when every
block replays the graph, 0 when every block is launched eagerly."""


def read(run):
    recs = [r for r in run.untraced() if "ar_graph_blocks" in r.seconds]
    K = max(2, int(run.engine.get("decode_steps", 8)))
    blocks = sum(r.steps for r in recs) / K
    return 100.0 * sum(r.seconds["ar_graph_blocks"] for r in recs) / blocks if blocks else None
