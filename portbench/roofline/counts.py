"""Operations and bytes of the program's hand kernels, from their shapes.

Each input byte is counted once and each output byte once, whatever the
kernel reads again. A policy's node score takes at least one multiply
and one add per feature and node (``OPS_PER_NODE``); the features'
own arithmetic is not counted, so a share of the roofline is a lower
bound of the work's and can never pass 100% by over-counting.
"""

FEATURES = 16
OPS_PER_NODE = 2 * FEATURES
I32 = F32 = 4


def param_score_bytes(lanes: int, nodes: int, gpus: int) -> int:
    """One call of ``param_score`` on ``[lanes, nodes]`` as the engines
    make it: per lane the pod (4 fields), the free CPU, memory and GPU
    count of every node, the free milli of every GPU slot, the weights and
    the scores written; once for all lanes the node totals (CPU, memory,
    GPU count), the node mask (bytes), the slots' milli capacity and
    their mask (bytes)."""
    per_lane = (4 * I32 + 3 * nodes * I32 + nodes * gpus * I32
                + FEATURES * F32 + nodes * I32)
    shared = 3 * nodes * I32 + nodes + nodes * gpus * I32 + nodes * gpus
    return lanes * per_lane + shared


def param_score_ops(lanes: int, nodes: int) -> int:
    return lanes * nodes * OPS_PER_NODE


def fused_sim_bytes(pop: int, slots: int, nodes: int, gpus: int,
                    snapshots: int) -> int:
    """One launch of ``fused_sim``: in, the weights [P, 16], the slots'
    first times [Q], the pod rows [Q, 8], the snapshot table [K], six node
    rows [6, N], the GPU slots' capacity and mask [N, G]; out, the slots'
    final state [P, Q], free CPU, memory and GPU count [P, N] each, free
    milli [P, N, G] and sixteen counters [P, 16]."""
    inputs = (pop * FEATURES * F32 + slots * I32 + slots * 8 * I32
              + snapshots * I32 + 6 * nodes * I32 + 2 * nodes * gpus * I32)
    outputs = (pop * slots * I32 + 3 * pop * nodes * I32
               + pop * nodes * gpus * I32 + pop * 16 * I32)
    return inputs + outputs


def fused_sim_ops(scored_events: int, nodes: int) -> int:
    """The node sweeps of every CREATE event the lanes processed."""
    return scored_events * nodes * OPS_PER_NODE
