"""Test client for the REST serving demo (`serve/restapi.py`).

Port of `dmayolo_tpu/serve/example_request.py` (the reference's
utils/flask_rest_api/example_request.py, which uses `requests`; this one
is stdlib-only, like the server).

    python -m dmayolo_tpu_torch.serve.example_request [image.jpg] [url]
"""
import json
import pprint
import sys
import urllib.request
import uuid

DETECTION_URL = "http://localhost:5000/v1/object-detection"


def detect(image_path: str, url: str = DETECTION_URL):
    """POST the image file as multipart/form-data; returns the JSON records."""
    with open(image_path, "rb") as f:
        data = f.read()
    boundary = uuid.uuid4().hex
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="image"; filename="{image_path}"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


if __name__ == "__main__":
    image = sys.argv[1] if len(sys.argv) > 1 else "bus.jpg"
    url = sys.argv[2] if len(sys.argv) > 2 else DETECTION_URL
    pprint.pprint(detect(image, url))
