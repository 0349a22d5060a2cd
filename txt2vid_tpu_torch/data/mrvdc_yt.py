"""YouTube category lookup for MSRVDC clips (counterpart of
txt2vid_tpu/data/mrvdc_yt.py), a dataset-curation side tool: batches of 50
video ids through the YouTube Data API's videos().list(part="snippet"),
mapped to their categoryId.

It needs google-api-python-client, an API key and the network. Without the
client it raises RuntimeError and contacts nothing.

    python -m txt2vid_tpu_torch.data.mrvdc_yt --ids ids.txt --api_key KEY --out cats.pickle
"""


def lookup_categories(video_ids, api_key=None, client_secrets=None) -> dict:
    """{video id: categoryId} for the ids the API returns."""
    try:
        from googleapiclient.discovery import build  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "google-api-python-client is not available in this environment; "
            "run this curation tool on a networked machine") from e

    youtube = build("youtube", "v3", developerKey=api_key)
    categories = {}
    ids = list(video_ids)
    for i in range(0, len(ids), 50):
        chunk = ids[i:i + 50]
        resp = youtube.videos().list(part="snippet", id=",".join(chunk)).execute()
        for item in resp.get("items", []):
            categories[item["id"]] = item["snippet"].get("categoryId")
    return categories


if __name__ == "__main__":
    import argparse
    import pickle

    p = argparse.ArgumentParser(description="YouTube categories of video ids.")
    p.add_argument("--ids", required=True, help="text file of YouTube video ids")
    p.add_argument("--api_key", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    with open(a.ids) as f:
        ids = [line.strip() for line in f if line.strip()]
    cats = lookup_categories(ids, api_key=a.api_key)
    with open(a.out, "wb") as f:
        pickle.dump(cats, f)
    print(f"{len(cats)} categories")
