"""Launch counts of the hand-written kernels, eager and replayed.

Each kernel module counts its eager launches on the host (its ``LAUNCHES``)
and keeps a ``ReplayCounter`` for the launches that a CUDA graph makes
(``ops.device_loop``): a launch captured into a graph adds one to a 0-dim
int64 counter on its card each time a replay runs it, IF nodes included,
where no host code runs to count it.
"""

import torch


class ReplayCounter:
    """The replayed launches of one kernel, a counter on each card."""

    def __init__(self, name):
        self.name = name
        self._counters = {}  # device → 0-dim int64

    def total(self):
        """Launches made by graph replays (one host read a card)."""
        return sum(self.by_device().values())

    def by_device(self):
        """{card: launches made there by graph replays} (one read a card)."""
        return {d: int(c.item()) for d, c in self._counters.items()}

    def prepare(self, device):
        """Make the card's counter, for a kernel whose first launch on it may
        be a captured one."""
        device = torch.device(device)
        if device not in self._counters:
            self._counters[device] = torch.zeros((), dtype=torch.int64, device=device)

    def reset(self):
        for c in self._counters.values():
            c.zero_()

    def slot(self, device):
        """The card's counter for a launch on ``device``, for a kernel that
        counts its own replays: under capture the counter, to which the
        captured launch adds one each time a replay runs it; eagerly None,
        for the caller to count on the host. The counter of a card is made
        at the first eager launch there; a graph's warm-up makes one before
        every capture."""
        if torch.cuda.is_current_stream_capturing():
            if device not in self._counters:
                raise RuntimeError(f"{self.name}: captured before any eager launch on its device")
            return self._counters[device]
        if device not in self._counters:
            self._counters[device] = torch.zeros((), dtype=torch.int64, device=device)
        return None

    def captured(self, device):
        """Count one launch on ``device``: True when it is being captured
        (the card then counts it at every replay that runs it, by a graph
        node that this adds), False when it runs eagerly, for the caller to
        count on the host."""
        counter = self.slot(device)
        if counter is None:
            return False
        counter.add_(1)
        return True
