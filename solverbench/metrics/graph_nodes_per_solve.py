"""Graph nodes the program replayed over the window
(``graphs.stats["nodes_replayed"]``) per solve of the window."""


def read(run):
    nodes = run.window_counters.get("nodes_replayed")
    if not nodes or not run.latencies:
        return None
    return nodes / len(run.latencies)
