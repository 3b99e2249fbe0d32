"""Helpers of the tests that read a Pipeline's span paths
(``Pipeline.step_seconds``, subphaser_torch/utils/profiling.py): a path
holds host seconds; ``path@device`` stream seconds and ``path@<name>`` a
counter."""


def steps(seconds: dict) -> list[str]:
    """The top-level paths, the steps, in the order they ended."""
    return [p for p in seconds if "/" not in p and "@" not in p]


def sub_spans(seconds: dict) -> set[str]:
    """The nested spans' paths (host seconds only)."""
    return {p for p in seconds if "/" in p and "@" not in p}


def assert_children_within_parents(seconds: dict, slack: float = 1e-3) -> None:
    """Every span's direct children's host seconds sum to no more than its
    own plus ``slack``."""
    host = {p: s for p, s in seconds.items() if "@" not in p}
    for parent, s in host.items():
        kids = sum(v for p, v in host.items() if p.rpartition("/")[0] == parent)
        assert kids <= s + slack, (parent, kids, s)
