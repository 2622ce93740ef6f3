"""Image download utility of the service (stdlib urllib; the decode and
the save go through serve/imageio.py)."""
from __future__ import annotations

import os
import re
import time
import urllib.error
import urllib.request
from urllib.parse import urlsplit

from yolov8_vit_tpu_torch.serve import imageio


def safe_filename(name: str, default_ext: str = ".jpg") -> str:
    """Reduce an attacker-controllable name to a single safe path component.

    Strips directories (both separators), refuses dot-names, and guarantees
    an image-writable extension."""
    name = os.path.basename(name.replace("\\", "/")).strip()
    if not name or name in (".", "..") or name.startswith("."):
        name = f"downloaded_image_{int(time.time())}{default_ext}"
    if "." not in name:
        name += default_ext
    return name


def claim_unique_path(save_path: str) -> str:
    """Reserve a collision-free variant of save_path (stem, stem-1, ...).

    Two URLs in one upload request can share a basename (camA/img.jpg and
    camB/img.jpg); overwriting would silently drop one image from the
    response.  O_CREAT|O_EXCL makes the claim atomic across the parallel
    download threads."""
    stem, ext = os.path.splitext(save_path)
    for n in range(1000):
        candidate = save_path if n == 0 else f"{stem}-{n}{ext}"
        try:
            os.close(os.open(candidate, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return candidate
        except FileExistsError:
            continue
    return save_path


def download_images(url: str, save_folder: str, save_flag: bool | int = True):
    """GET url (10 s timeout) -> decode to a BGR ndarray.

    save_flag truthy: write to save_folder (filename from the URL's path,
    query params stripped; Content-Disposition / timestamp fallback) and
    return the saved path.  Falsy: return the decoded image.  Returns False
    on any failure."""
    try:
        with urllib.request.urlopen(url, timeout=10) as response:
            content = response.read()
            headers = response.headers
    except (urllib.error.URLError, ValueError, OSError) as e:
        print(f"Error downloading {url}: {e}")
        return False

    image = imageio.imdecode(content)
    if image is None:
        print(f"Error decoding image from {url}")
        return False

    if not save_flag:
        return image

    # split the URL first: basename on the raw string picks the tail of a
    # query value when the signature carries '/' (presigned URLs routinely
    # do), and a '#fragment' would survive into the extension
    image_filename = os.path.basename(urlsplit(url).path)
    if not image_filename:
        cd = headers.get("content-disposition")
        if cd:
            # matches both `filename=` and RFC 5987 `filename*=`
            # (whose value carries a charset prefix: UTF-8''name.jpg)
            fname = re.findall(r"filename\*?=([^;]+)", cd,
                               flags=re.IGNORECASE)
            if fname and "''" in fname[0]:
                fname[0] = fname[0].split("''", 1)[1]
            if fname:
                image_filename = fname[0].strip("\"' ")
    # URL and Content-Disposition are attacker-controlled: keep only the
    # final path component and refuse anything that could escape save_folder.
    image_filename = safe_filename(image_filename)

    os.makedirs(save_folder, exist_ok=True)
    save_path = claim_unique_path(os.path.join(save_folder, image_filename))
    try:
        imageio.imwrite(save_path, image)
        return save_path
    except Exception as e:  # noqa: BLE001 - any write failure is a False
        print(f"Error saving image to {save_path}: {e}")
        return False
