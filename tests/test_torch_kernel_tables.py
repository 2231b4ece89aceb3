"""Each kernel library's constant tables on every card that launches it.

A library's tables are `__device__` / `__constant__` symbols, one copy a
card, and `cudaMemcpyToSymbol` sets the current card's only. The three
loaders that upload (`poseidon_kernel._library`, `poseidon_bn254_kernel.
_library`, `witness_kernel._library`, through `cuda_build.library_on`)
must upload once for each card, inside `torch.cuda.device` of the card the
tensor is on, before its first launch, and never again for a card already
served; a process whose current card is 0 launching on card 1 must find
card 1's tables set. Runs on the CPU: a fake library records the current
card at each upload, and a fake `torch.cuda.device` / `current_device`
stand for the cards."""
import contextlib
import ctypes

import pytest
import torch

from stark_verifier_tpu_torch.ops import cuda_build
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from stark_verifier_tpu_torch.ops import witness_kernel as WK

# the table uploads of each library, as its loader calls them
UPLOADS = {"poseidon_gl": ["poseidon_set_round_constants", "poseidon_set_partial_constants"],
           "poseidon_gl_mma": ["poseidon_mma_set_round_constants",
                               "poseidon_mma_set_partial_constants"],
           "poseidon_bn254": ["bridge_set_constants"],
           "witness": ["witness_set_tables"]}
LOADERS = {"poseidon_gl": lambda dev: pk._library("poseidon_gl", dev),
           "poseidon_gl_mma": lambda dev: pk._library("poseidon_gl_mma", dev),
           "poseidon_bn254": bk._library,
           "witness": WK._library}


class _Cards:
    """torch.cuda's current card, faked: `device(d)` makes d current for
    its block, `current_device()` reads it."""

    def __init__(self):
        self.current = 0

    @contextlib.contextmanager
    def device(self, dev):
        index = dev.index if isinstance(dev, torch.device) else int(dev)
        before, self.current = self.current, index
        try:
            yield
        finally:
            self.current = before

    def current_device(self):
        return self.current


class _Function:
    def __init__(self, lib, name):
        self.lib, self.name, self.argtypes, self.restype = lib, name, None, None

    def __call__(self, *args):
        if self.name == "witness_table_words":
            return WK.fill_tables().size
        if self.name == "witness_set_tables":   # the table, read as the copy does
            words = WK.fill_tables().size
            self.lib.tables = (ctypes.c_uint64 * words).from_address(args[0])[:]
        self.lib.calls.append((self.name, self.lib.cards.current))
        return self.lib.fail.get(self.name, 0)


class _Library:
    """A loaded library, faked: records each call with the card current at
    it; `fail[name]` makes that call return a CUDA error."""

    def __init__(self, cards):
        self.cards, self.calls, self.fns, self.fail = cards, [], {}, {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _Function(self, name))


@pytest.fixture
def cards(monkeypatch):
    """Fresh loader state, fake cards and one fake library a name."""
    cards = _Cards()
    libs = {}
    monkeypatch.setattr(cuda_build, "_bound", set())
    monkeypatch.setattr(cuda_build, "_served", {})
    monkeypatch.setattr(cuda_build, "load",
                        lambda name: libs.setdefault(name, _Library(cards)))
    monkeypatch.setattr(torch.cuda, "device", cards.device)
    monkeypatch.setattr(torch.cuda, "current_device", cards.current_device)
    cards.libs = libs
    return cards


@pytest.mark.parametrize("name", list(LOADERS))
def test_tables_uploaded_once_a_card_on_that_card(cards, name):
    """Card 1 first while card 0 is current, then card 0, card 1 again, a
    bare "cuda" (the current card, 0), then a bare "cuda" with card 2
    current: one upload of each table for cards 1, 0 and 2, each while that
    card was current, none again; the current card is left as it was."""
    load = LOADERS[name]
    lib = load(torch.device("cuda", 1))
    assert cards.current == 0
    assert load(torch.device("cuda", 0)) is lib
    assert load(torch.device("cuda", 1)) is lib
    assert load(torch.device("cuda")) is lib
    cards.current = 2
    assert load(torch.device("cuda")) is lib
    assert cards.current == 2
    uploads = [call for call in lib.calls if call[0] in UPLOADS[name]]
    assert uploads == [(setter, card) for card in (1, 0, 2) for setter in UPLOADS[name]]
    assert set(cuda_build._served[name]) == {0, 1, 2}
    if name == "witness":
        assert lib.tables == WK.fill_tables().tolist()


@pytest.mark.parametrize("name", list(LOADERS))
def test_signatures_bound_once_a_process(cards, name):
    """The C signatures are bound when the library first loads, for every
    card after it: each upload and kernel entry point has its argtypes."""
    load = LOADERS[name]
    lib = load(torch.device("cuda", 0))
    bound = {n: fn.argtypes for n, fn in lib.fns.items()}
    assert all(bound[setter] is not None for setter in UPLOADS[name])
    load(torch.device("cuda", 3))
    assert {n: fn.argtypes for n, fn in lib.fns.items()} == bound
    assert cuda_build._bound == {name}


@pytest.mark.parametrize("name", list(LOADERS))
def test_failed_upload_raises_and_leaves_the_card_unserved(cards, name):
    """A CUDA error from an upload raises, and the card is not marked as
    served: the next launch there uploads again."""
    load = LOADERS[name]
    load(torch.device("cuda", 0))
    lib = cards.libs[name]
    lib.fail[UPLOADS[name][0]] = 2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        load(torch.device("cuda", 1))
    assert cuda_build._served[name] == {0}
    lib.fail.clear()
    load(torch.device("cuda", 1))
    assert cuda_build._served[name] == {0, 1}
    assert [c for c, card in lib.calls if c == UPLOADS[name][0] and card == 1] == [
        UPLOADS[name][0]] * 2


def test_each_library_keeps_its_own_cards(cards):
    """Serving a card for one library serves it for no other: the two
    Poseidon libraries, the bridge's and the witness kernels' each upload
    to card 1 on their own first launch there."""
    for name, load in LOADERS.items():
        load(torch.device("cuda", 1))
    assert {name: cuda_build._served[name] for name in LOADERS} == {
        name: {1} for name in LOADERS}
    assert all(card == 1 for lib in cards.libs.values() for _, card in lib.calls)
