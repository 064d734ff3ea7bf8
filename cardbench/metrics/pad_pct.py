"""Share of the tree pass's lanes that carried no node:
100 x pad_nodes_total / tree_lanes_total over the window."""


def read(rec):
    lanes = rec.delta("tree_lanes_total")
    return 100.0 * rec.delta("pad_nodes_total") / lanes if lanes else None
