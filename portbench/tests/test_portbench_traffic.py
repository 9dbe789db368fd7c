"""The traffic generator repeats exactly from a seed, and a seed changes the
inputs but not the sizes of the work."""
import torch

from portbench.core import registry, traffic, weights

import portbench_tiny


def test_training_batches_repeat_from_the_seed():
    cell = registry.cell(registry.benchmark(), "xlstm-train-2k")
    model, tr, _ = portbench_tiny.tiny(cell)
    a = traffic.train_batches(tr, model, 2 ** 33 + 7, "cpu")
    b = traffic.train_batches(tr, model, 2 ** 33 + 7, "cpu")
    c = traffic.train_batches(tr, model, 2 ** 33 + 8, "cpu")
    assert len(a) == tr["distinct_batches"]
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])        # rows that all differ
    assert torch.equal(a[0]["tokens"][:, 1:], a[0]["labels"][:, :-1])
    assert int(a[0]["tokens"].max()) < model["vocab_size"] and int(a[0]["tokens"].min()) >= 0


def test_embedding_batches_repeat_from_the_seed():
    cell = registry.cell(registry.benchmark(), "musicgen-train-30s")
    model, tr, _ = portbench_tiny.tiny(cell)
    a = traffic.train_batches(tr, model, 5, "cpu")
    b = traffic.train_batches(tr, model, 5, "cpu")
    assert a[0]["embeds"].shape == (2, 64, 64) and a[0]["labels"].shape == (2, 64, 4)
    assert torch.equal(a[1]["embeds"], b[1]["embeds"]) and torch.equal(a[1]["labels"], b[1]["labels"])


def test_weights_repeat_from_the_seed():
    cell = registry.cell(registry.benchmark(), "xlstm-train-2k")
    model, _, _ = portbench_tiny.tiny(cell)
    leaves = cell.reference.leaves(model)
    a = dict(weights.draw(leaves, 9, "cpu"))
    b = dict(weights.draw(leaves, 9, "cpu"))
    assert set(a) == {leaf.name for leaf in leaves}
    assert all(torch.equal(a[k], b[k]) for k in a)
    f = a["layers.0.mixer.w_f.bias"]
    assert torch.allclose(f, torch.linspace(3.0, 6.0, 4))
