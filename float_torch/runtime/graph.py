"""ComfyUI workflow-graph executor: parse, flatten, topo-run node graphs
(the port's copy of ``float_tpu.runtime.graph``, which is pure Python).

The reference is a ComfyUI node package — its users express pipelines as
node GRAPHS (the example_workflows/*.json, SURVEY §3.3/§3.5).  This
module executes that serialized format against the port's node-function
surface (api/nodes.py), so a workflow file runs here unchanged:

    from float_torch.api.comfy import GraphContext, run_comfy_workflow
    results, ctx = run_comfy_workflow(
        "example_workflows/graph_regular.json",
        GraphContext(device="cuda", inputs_dir="assets",
                     models_root="models"))

Format notes (ComfyUI litegraph serialization, verified against the
reference's example_workflows):
- ``nodes``: each has ``id``, ``type``, ``mode`` (0=run, 2=mute,
  4=bypass), ordered ``inputs`` (entries with a ``widget`` key are widget
  inputs; others carry a ``link`` id), ``outputs`` (with ``links``), and
  ``widgets_values`` — a LIST aligned with the widget inputs in order
  (plus phantom "control_after_generate" entries after seed widgets), or
  a DICT keyed by widget name (newer nodes, e.g. VHS_VideoCombine).
- ``links``: either ``[id, src_node, src_slot, dst_node, dst_slot,
  type]`` arrays (top level) or ``{id, origin_id, origin_slot,
  target_id, target_slot, type}`` dicts (subgraphs).
- ``definitions.subgraphs``: reusable sub-flows.  An *instance* node's
  ``type`` is the subgraph's UUID; the pseudo-node id -10 is the
  subgraph's input boundary (its slot k = subgraph input k, fed by the
  instance's input slot k — a parent link or an instance widget value)
  and -20 the output boundary (slot k = instance output slot k).
  Instances nest; this executor flattens them recursively.

The adapter registry that maps node types to framework calls lives in
api/comfy.py; this module is format/scheduling only.
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("float_torch.graph")

# node types that are pure annotations — never executed, never adapters
NOTE_TYPES = frozenset({"MarkdownNote", "Note", "Reroute"})

# ComfyUI mode values
MODE_RUN, MODE_MUTE, MODE_BYPASS = 0, 2, 4

_SEED_CONTROL_VALUES = frozenset(
    {"fixed", "randomize", "increment", "decrement"})


class GraphError(Exception):
    """Malformed workflow JSON or unexecutable graph."""


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

# a value source feeding a node input:
#   ("node", exec_key, out_slot)  — another node's output
#   ("value", v)                  — a constant (widget on a subgraph instance)
Source = Tuple


@dataclass
class ExecNode:
    """One flattened, executable node."""
    key: str                      # namespaced id, e.g. "120/58"
    type: str
    title: str
    mode: int
    widgets: Dict[str, Any]                       # widget name -> value
    conn: Dict[str, Optional[Source]]             # connection input -> source
    conn_types: Dict[str, str] = field(default_factory=dict)
    out_names: List[str] = field(default_factory=list)
    out_types: List[str] = field(default_factory=list)


def bind_widget_values(node: dict) -> Dict[str, Any]:
    """Zip a node's widget-input names with its ``widgets_values``.

    Handles the dict form, and in the list form skips the phantom
    control_after_generate value ComfyUI appends after seed widgets.
    """
    names = [i["name"] for i in node.get("inputs", []) if i.get("widget")]
    vals = node.get("widgets_values")
    if isinstance(vals, dict):
        return {n: vals[n] for n in names if n in vals}
    out: Dict[str, Any] = {}
    vi = 0
    vals = list(vals) if vals is not None else []
    for n in names:
        if vi >= len(vals):
            break
        out[n] = vals[vi]
        vi += 1
        if ("seed" in n and vi < len(vals)
                and vals[vi] in _SEED_CONTROL_VALUES):
            vi += 1              # control_after_generate phantom entry
    return out


def _parse_links(raw_links) -> Dict[Any, Tuple[Any, int, Any, int]]:
    """link id -> (origin_id, origin_slot, target_id, target_slot)."""
    out = {}
    for lk in raw_links or []:
        if isinstance(lk, dict):
            out[lk["id"]] = (lk["origin_id"], lk["origin_slot"],
                             lk["target_id"], lk["target_slot"])
        else:
            lid, o, os_, t, ts, *_ = lk
            out[lid] = (o, os_, t, ts)
    return out


def flatten_graph(wf: dict) -> Dict[str, ExecNode]:
    """Workflow JSON -> flat {exec_key: ExecNode} with subgraphs expanded."""
    defs = {sg["id"]: sg for sg in
            wf.get("definitions", {}).get("subgraphs", [])}
    acc: Dict[str, ExecNode] = {}
    _expand_level(wf.get("nodes", []), wf.get("links", []),
                  defs, "", None, acc)
    return acc


def _expand_level(raw_nodes, raw_links, defs, prefix,
                  ext_sources: Optional[Dict[int, Optional[Source]]],
                  acc: Dict[str, ExecNode]) -> Callable[[Any, int], Optional[Source]]:
    """Expand one graph level (top level or a subgraph instance body).

    Adds ExecNodes for the level's real nodes to ``acc`` and returns a
    ``resolve(node_id, out_slot) -> Source`` for this level's namespace.
    ``ext_sources`` feeds the -10 input boundary (None at top level).
    """
    nodes = {n["id"]: n for n in raw_nodes}
    links = _parse_links(raw_links)
    inst_outs: Dict[Any, Dict[int, Optional[Source]]] = {}

    def resolve(nid, slot) -> Optional[Source]:
        hops = 0
        while True:
            if nid == -10:
                if ext_sources is None:
                    raise GraphError("input boundary (-10) at top level")
                return ext_sources.get(slot)
            node = nodes.get(nid)
            if node is None:
                raise GraphError(f"link references unknown node id {nid!r}")
            if node["type"] == "Reroute":
                # classic ComfyUI reroute NODES are pure passthrough (the
                # reference workflows use the newer link-level `reroutes`
                # metadata instead, which needs no handling)
                hops += 1
                if hops > len(nodes):
                    raise GraphError(f"reroute cycle at node {nid}")
                inp = next((i for i in node.get("inputs", [])
                            if i.get("link") is not None), None)
                if inp is None:
                    return None
                lid = inp["link"]
                if lid not in links:
                    raise GraphError(f"reroute {nid}: link {lid} not in "
                                     "links table")
                nid, slot = links[lid][0], links[lid][1]
                continue
            if node["type"] in defs:
                if nid not in inst_outs:
                    inst_outs[nid] = _expand_instance(node)
                return inst_outs[nid].get(slot)
            return ("node", prefix + str(nid), slot)

    def input_sources(node) -> List[Tuple[str, Optional[Source], str]]:
        """Ordered (name, source, type) over the node's inputs; widget
        inputs become ("value", ...) sources."""
        widgets = bind_widget_values(node)
        out = []
        for inp in node.get("inputs", []):
            name, typ = inp["name"], inp.get("type", "*")
            lid = inp.get("link")
            if lid is not None:
                # a connection wins even on a widget input (a widget
                # "converted to input" keeps its widget key + a link, and
                # widgets_values retains a stale slot for it)
                if lid not in links:
                    raise GraphError(
                        f"node {node['id']} input {name!r}: link {lid} "
                        "not in links table")
                o, oslot, _t, _ts = links[lid]
                src = resolve(o, oslot)
            elif inp.get("widget"):
                src = ("value", widgets[name]) if name in widgets else None
            else:
                src = None
            out.append((name, src, typ))
        return out

    def _expand_instance(inst) -> Dict[int, Optional[Source]]:
        sg = defs[inst["type"]]
        mode = inst.get("mode", MODE_RUN)
        if mode == MODE_MUTE:
            return {}                     # every output reads as None
        ins = input_sources(inst)
        if mode == MODE_BYPASS:
            # pass each output through the first same-typed input,
            # without expanding (or executing) the instance body
            outs: Dict[int, Optional[Source]] = {}
            for k, out in enumerate(inst.get("outputs", [])):
                typ = out.get("type", "*")
                outs[k] = next((s for _n, s, ty in ins
                                if ty == typ and s is not None), None)
            return outs
        ext = {i: s for i, (_n, s, _t) in enumerate(ins)}
        sub_resolve = _expand_level(
            sg.get("nodes", []), sg.get("links", []), defs,
            prefix + str(inst["id"]) + "/", ext, acc)
        outs: Dict[int, Optional[Source]] = {}
        for (o, oslot, t, tslot) in _parse_links(sg.get("links", [])).values():
            if t == -20:
                outs[tslot] = sub_resolve(o, oslot)
        return outs

    for nid, node in nodes.items():
        t = node["type"]
        if t in NOTE_TYPES:
            continue
        if t in defs:
            if nid not in inst_outs:          # expand even if unconsumed —
                inst_outs[nid] = _expand_instance(node)  # side-effect nodes
            continue
        ins = input_sources(node)
        widgets = bind_widget_values(node)
        conn, conn_types = {}, {}
        for n, s, ty in ins:
            if n in widgets and s == ("value", widgets[n]):
                continue      # plain widget input — value carried in widgets
            conn[n] = s       # link (wins over a stale widget value at
            conn_types[n] = ty  # execution), boundary value, or unconnected
        acc[prefix + str(nid)] = ExecNode(
            key=prefix + str(nid), type=t,
            title=node.get("title", t), mode=node.get("mode", 0),
            widgets=widgets, conn=conn, conn_types=conn_types,
            out_names=[o["name"] for o in node.get("outputs", [])],
            out_types=[o.get("type", "*") for o in node.get("outputs", [])])
    return resolve


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _toposort(exec_nodes: Dict[str, ExecNode]) -> List[str]:
    deps = {k: set() for k in exec_nodes}
    for k, n in exec_nodes.items():
        for src in n.conn.values():
            if src and src[0] == "node":
                if src[1] not in exec_nodes:
                    raise GraphError(
                        f"node {k} ({n.type}) consumes missing node "
                        f"{src[1]} (muted or note?)")
                deps[k].add(src[1])
    order, done = [], set()
    pending = dict(deps)
    while pending:
        ready = sorted(k for k, d in pending.items() if d <= done)
        if not ready:
            raise GraphError(f"cycle among nodes: {sorted(pending)}")
        for k in ready:
            order.append(k)
            done.add(k)
            del pending[k]
    return order


def _source_value(src: Optional[Source], results) -> Any:
    if src is None:
        return None
    kind = src[0]
    if kind == "value":
        return src[1]
    _, key, slot = src
    row = results.get(key)
    if row is None:
        return None
    if slot >= len(row):
        raise GraphError(
            f"node {key} produced {len(row)} outputs; slot {slot} requested")
    return row[slot]


def _bypass_outputs(node: ExecNode, results) -> List[Any]:
    """ComfyUI bypass: each output passes through the first input whose
    declared type matches (else None)."""
    out = []
    for typ in node.out_types or ["*"] * len(node.out_names):
        val = None
        for name, src in node.conn.items():
            if node.conn_types.get(name) == typ:
                val = _source_value(src, results)
                break
        out.append(val)
    return out


def run_graph(wf, registry: Dict[str, Callable], ctx) -> Dict[str, List[Any]]:
    """Execute a workflow (dict or JSON path) against an adapter registry.

    ``registry[type](ctx, inputs: dict) -> sequence`` returns the node's
    outputs in its canonical slot order.  ``ctx`` carries IO roots and
    per-node overrides (see api/comfy.py GraphContext).  Returns
    {exec_key: [outputs]} for every executed node.
    """
    if isinstance(wf, str):
        with open(wf) as f:
            wf = json.load(f)
    exec_nodes = flatten_graph(wf)

    unknown = sorted({n.type for n in exec_nodes.values()
                      if n.type not in registry and n.mode == MODE_RUN})
    if unknown:
        raise GraphError(
            f"no adapter registered for node type(s): {', '.join(unknown)}")

    results: Dict[str, List[Any]] = {}
    for key in _toposort(exec_nodes):
        node = exec_nodes[key]
        if node.mode == MODE_MUTE:
            results[key] = [None] * max(1, len(node.out_names))
            continue
        if node.mode == MODE_BYPASS:
            results[key] = _bypass_outputs(node, results)
            continue
        inputs = dict(node.widgets)
        for name, src in node.conn.items():
            inputs[name] = _source_value(src, results)
        for sel in (node.type, node.title, node.key):
            ov = getattr(ctx, "overrides", None) or {}
            if sel in ov:
                inputs.update(ov[sel])
        logger.info("run %s (%s)", node.type, key)
        try:
            outs = registry[node.type](ctx, inputs)
        except GraphError:
            raise
        except Exception as exc:
            raise GraphError(
                f"node {key} ({node.type}) failed: {exc}") from exc
        results[key] = list(outs) if outs is not None else []
    return results
