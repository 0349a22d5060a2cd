"""Scraped reddit-video captions (counterpart of txt2vid_tpu/data/reddit.py):
a JSON list of {url, title} -> a {key: [titles]} pickle, each key the url
with `:/?&=.%` replaced by `_`, the name the cached clip has.

    python -m txt2vid_tpu_torch.data.reddit --json videos.json --out sent.pickle
"""

import json
import pickle


def url_to_key(url: str) -> str:
    for ch in ":/?&=.%":
        url = url.replace(ch, "_")
    return url


def convert(json_path, out_path) -> dict:
    """Write and return {url_to_key(url): [titles]} in the file's order."""
    with open(json_path) as f:
        entries = json.load(f)
    result = {}
    for e in entries:
        result.setdefault(url_to_key(e["url"]), []).append(e["title"])
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    return result


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="reddit {url, title} JSON -> a captions pickle.")
    p.add_argument("--json", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    print(f"{len(convert(a.json, a.out))} videos")
