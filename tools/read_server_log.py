#!/usr/bin/env python3
"""Render server logs as a searchable HTML table
(reference tools/read_usrp_log.py:1-187).

The log format is TimeStamp;ThreadName;Severity;Message
(utils/log.py, mirroring the reference boost::log sink).
"""

import argparse
import glob
import html
import os
import sys

_PAGE = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>gpu_sdr server log</title>
<style>
 body {{ font-family: monospace; }}
 table {{ border-collapse: collapse; width: 100%; }}
 td, th {{ border: 1px solid #ccc; padding: 2px 6px; }}
 tr.ERROR {{ background: #fdd; }}
 tr.WARNING {{ background: #ffd; }}
 input {{ width: 50%; margin-bottom: 8px; }}
</style>
<script>
function filt() {{
  var q = document.getElementById('q').value.toLowerCase();
  var rows = document.querySelectorAll('tbody tr');
  rows.forEach(function(r) {{
    r.style.display = r.textContent.toLowerCase().includes(q) ? '' : 'none';
  }});
}}
</script></head><body>
<h2>{title}</h2>
<input id="q" onkeyup="filt()" placeholder="filter...">
<table><thead><tr><th>Time</th><th>Thread</th><th>Severity</th>
<th>Message</th></tr></thead><tbody>
{rows}
</tbody></table></body></html>"""


def render(log_path: str, out_path: str) -> int:
    rows = []
    with open(log_path) as f:
        for line in f:
            parts = line.rstrip("\n").split(";", 3)
            if len(parts) != 4:
                continue
            ts, thread, sev, msg = (html.escape(p) for p in parts)
            rows.append(f'<tr class="{sev}"><td>{ts}</td><td>{thread}</td>'
                        f"<td>{sev}</td><td>{msg}</td></tr>")
    page = _PAGE.format(title=html.escape(os.path.basename(log_path)),
                        rows="\n".join(rows))
    with open(out_path, "w") as f:
        f.write(page)
    return len(rows)


def main():
    parser = argparse.ArgumentParser(description="Log file -> HTML table.")
    parser.add_argument("--log", "-l", type=str, default=None,
                        help="log file (default: newest in logs/)")
    parser.add_argument("--out", "-o", type=str, default=None)
    args = parser.parse_args()
    log_path = args.log
    if log_path is None:
        cands = sorted(glob.glob("logs/*.log"))
        if not cands:
            print("no log files found in logs/")
            return 1
        log_path = cands[-1]
    out = args.out or os.path.splitext(log_path)[0] + ".html"
    n = render(log_path, out)
    print(f"{n} records written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
