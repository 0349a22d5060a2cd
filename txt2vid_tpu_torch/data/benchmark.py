"""Data-loading micro-benchmark (counterpart of txt2vid_tpu/data/benchmark.py):
the seconds to read a dataset's items one by one, in all and per item.

    python -m txt2vid_tpu_torch.data.benchmark --data SPEC [--anno A] [--vocab V] \\
        [--num_items N]

--data is a dataset spec of the config surface (config.py), e.g.
'{"class": "txt2vid_tpu.data.my_dataset", "args": {"data": "CLIPS"}}'.
"""

from txt2vid_tpu_torch.utils.stopwatch import Stopwatch


def benchmark(dataset, num_items=None) -> tuple[float, float]:
    """(total seconds, seconds per item) over the first num_items items (all
    by default)."""
    n = len(dataset) if num_items is None else min(num_items, len(dataset))
    watch = Stopwatch()
    watch.start()
    for i in range(n):
        dataset[i]
    total = watch.stop()
    print(f"{n} items in {total:.3f}s ({total / max(n, 1):.5f} s/item)")
    return total, total / max(n, 1)


if __name__ == "__main__":
    import argparse

    from txt2vid_tpu_torch.config import create_object
    from txt2vid_tpu_torch.data import load_pickle

    p = argparse.ArgumentParser(description="Time reading a dataset's items.")
    p.add_argument("--data", required=True, help="dataset spec (json/class path)")
    p.add_argument("--anno", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--num_items", type=int, default=None)
    a = p.parse_args()
    vocab = load_pickle(a.vocab) if a.vocab else None
    dset = create_object(a.data, vocab=vocab, anno=a.anno)
    benchmark(dset, a.num_items)
