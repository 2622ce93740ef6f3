"""AMap geocoding (stdlib urllib)."""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request


def location2lalo(location: str):
    """Address string -> (formatted_address, "lng,lat") or (None, None).

    Requires AMAP_API_KEY in the environment."""
    api_key = os.environ.get("AMAP_API_KEY")
    if not api_key:
        print("location2lalo: AMAP_API_KEY not set")
        return None, None
    try:
        query = urllib.parse.urlencode({"address": location, "key": api_key})
        with urllib.request.urlopen(
                f"https://restapi.amap.com/v3/geocode/geo?{query}",
                timeout=5) as response:
            answer = json.loads(response.read())
        if answer.get("status") == "1" and answer.get("geocodes"):
            return (answer["geocodes"][0]["formatted_address"],
                    answer["geocodes"][0]["location"])
        print(f"AMap error: {answer.get('info', 'unknown')}")
        return None, None
    except (urllib.error.URLError, OSError, KeyError, IndexError,
            ValueError) as e:
        print(f"location2lalo error: {e}")
        return None, None
