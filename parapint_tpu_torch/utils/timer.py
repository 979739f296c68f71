"""Hierarchical phase timer (counterpart of ``parapint_tpu.utils.timer``).

Plays the role Pyomo's ``HierarchicalTimer`` plays in the reference: an
optional ``timer`` threaded through ``ip_solve``, with the reference's phase
labels.  PyTorch launches CUDA work asynchronously, so a phase's wall time
covers its device work only if the phase ends with a blocking read;
``ip_solve`` reads its per-iteration scalars to the host inside the timed
phases, which gives those points.  For per-kernel device time use
``torch.profiler``.
"""

import time
from typing import Dict, List


class _Node:
    __slots__ = ("total", "count", "children", "start")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.children: Dict[str, "_Node"] = {}
        self.start = None


class HierarchicalTimer:
    def __init__(self):
        self._root = _Node()
        self._stack: List[_Node] = [self._root]

    def start(self, name: str) -> None:
        node = self._stack[-1].children.setdefault(name, _Node())
        node.start = time.perf_counter()
        self._stack.append(node)

    def stop(self, name: str) -> None:
        node = self._stack[-1]
        if node is self._root or node.start is None:
            raise RuntimeError(f"stop({name!r}) without matching start")
        node.total += time.perf_counter() - node.start
        node.count += 1
        node.start = None
        self._stack.pop()

    def context(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                timer.start(name)

            def __exit__(self, *exc):
                timer.stop(name)

        return _Ctx()

    def _format(self, node: _Node, indent: int, lines: List[str]) -> None:
        for name, child in node.children.items():
            lines.append(f"{'  ' * indent}{name:<30} {child.total:>10.4f}s  (n={child.count})")
            self._format(child, indent + 1, lines)

    def __str__(self) -> str:
        lines: List[str] = ["HierarchicalTimer:"]
        self._format(self._root, 1, lines)
        return "\n".join(lines)
