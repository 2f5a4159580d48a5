"""Render the DIA DAG from a JSON event log as graphviz dot.

Equivalent of the reference's misc/json2graphviz.py. Usage:

    python -m thrill_tpu_torch.tools.json2graphviz LOG.json > dag.dot

A copy of the reference package's ``tools/json2graphviz.py`` that prints the
same bytes on the same logs, whichever package wrote them.
"""

from __future__ import annotations

import sys

from .json2profile import load_events


def render_dot(events) -> str:
    nodes = {}
    edges = set()
    for e in events:
        if e.get("event") == "node_execute_start":
            nid = e.get("dia_id")
            nodes[nid] = e.get("node", "?")
            for p in e.get("parents", []) or []:
                edges.add((p, nid))
        elif e.get("event") == "node_execute_done":
            nid = e.get("dia_id")
            if e.get("items") is not None and nid in nodes:
                nodes[nid] = f"{nodes[nid]}\\n{e['items']} items"
    lines = ["digraph dia {", "  rankdir=TB;",
             '  node [shape=box, fontname="monospace"];']
    for nid, label in sorted(nodes.items()):
        lines.append(f'  n{nid} [label="#{nid} {label}"];')
    for a, b in sorted(edges):
        lines.append(f"  n{a} -> n{b};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main() -> None:
    if len(sys.argv) != 2:
        print("usage: json2graphviz LOG.json > dag.dot", file=sys.stderr)
        sys.exit(2)
    sys.stdout.write(render_dot(load_events(sys.argv[1])))


if __name__ == "__main__":
    main()
