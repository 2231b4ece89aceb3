"""graph_nodes (layer: entry; moves batch_ms_p90): the nodes of the CUDA
graph the compiled verifier captured, by libcuda's cuGraphGetNodes; about
one a launch, each near the launch floor at small batches."""
UNIT = "nodes"


def read(run):
    return run.graph_nodes
