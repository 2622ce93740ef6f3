"""Object storage clients.

`AliyunOss` mirrors the reference client
(`utils/utils.py:90-130`: put_object_from_file / getUrl /
delete_object against a fixed bucket+endpoint) but takes credentials from
the environment only — no hardcoded secrets — and degrades to
`LocalObjectStore` when the `oss2` SDK or credentials are absent, so the
serving stack runs hermetically.
"""
from __future__ import annotations

import os
import shutil


class AliyunOss:
    def __init__(self, bucket_name: str | None = None,
                 endpoint: str | None = None):
        import oss2  # optional dependency

        key_id = os.environ["ALIYUN_ACCESS_KEY_ID"]
        key_secret = os.environ["ALIYUN_ACCESS_KEY_SECRET"]
        self.bucket_name = bucket_name or os.environ.get(
            "ALIYUN_OSS_BUCKET", "xiaowenjie")
        self.endpoint = endpoint or os.environ.get(
            "ALIYUN_OSS_ENDPOINT", "oss-cn-beijing.aliyuncs.com")
        self.bucket = oss2.Bucket(oss2.Auth(key_id, key_secret),
                                  self.endpoint, self.bucket_name)

    def put_object_from_file(self, name: str, file_path: str) -> bool:
        try:
            self.bucket.put_object_from_file(name, file_path)
            return True
        except Exception as e:  # noqa: BLE001
            print(f"Failed to upload {file_path} to OSS: {e}")
            return False

    def getUrl(self, name: str) -> str:  # noqa: N802 — reference API name
        return f"https://{self.bucket_name}.{self.endpoint}/{name}"

    def delete_object(self, name: str) -> bool:
        try:
            self.bucket.delete_object(name)
            return True
        except Exception as e:  # noqa: BLE001
            print(f"Error deleting object {name} from OSS: {e}")
            return False


class LocalObjectStore:
    """Filesystem stand-in with the same API (hermetic default)."""

    def __init__(self, root: str = "oss_local"):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put_object_from_file(self, name: str, file_path: str) -> bool:
        try:
            dst = os.path.join(self.root, name)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            shutil.copy(file_path, dst)
            return True
        except OSError as e:
            print(f"Failed to store {file_path}: {e}")
            return False

    def getUrl(self, name: str) -> str:  # noqa: N802
        return f"file://{os.path.abspath(os.path.join(self.root, name))}"

    def delete_object(self, name: str) -> bool:
        try:
            os.remove(os.path.join(self.root, name))
            return True
        except FileNotFoundError:
            return False


def make_object_store(root: str = "oss_local"):
    """AliyunOss when SDK+credentials exist, else LocalObjectStore."""
    try:
        return AliyunOss()
    except (ImportError, KeyError):
        return LocalObjectStore(root)
