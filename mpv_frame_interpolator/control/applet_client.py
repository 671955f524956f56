"""Settings-applet client: the widget-side counterpart of AppletServer.

The reference ships a 270-LoC GTK AppIndicator widget
(HopperRenderSettingsApplet.py) that reads 512-byte status blocks from the
FIFO and writes integer command codes back.  A GPU serving host has no
desktop, so this client renders the same protocol in a terminal:

    python -m mpv_frame_interpolator.control.applet_client /tmp/hr
    python -m ... --once          # print one status block and exit
    python -m ... --send 5        # send one command code and exit

Interactive keys (curses UI):
    a/d        activate / deactivate            (codes 1 / 0)
    0-6        frame output mode                (codes 2-8)
    l          cycle levels presets             (codes 9/10/11)
    +/-        white level up/down              (codes 400-655)
    q          quit
"""

from __future__ import annotations

import argparse
import os
import sys

BLOCK = 512


def read_status(fifo_path: str, timeout: float = 5.0) -> str:
    """Read one 512-byte status block from the server's FIFO."""
    import select
    fd = os.open(fifo_path, os.O_RDONLY | os.O_NONBLOCK)
    try:
        buf = b""
        while len(buf) < BLOCK:
            r, _, _ = select.select([fd], [], [], timeout)
            if not r:
                raise TimeoutError(f"no status from {fifo_path}")
            chunk = os.read(fd, BLOCK - len(buf))
            if not chunk:
                continue
            buf += chunk
        return buf.rstrip(b"\0").decode(errors="replace")
    finally:
        os.close(fd)


def send_code(fifo_path: str, code: int):
    """Write one command code on the command FIFO (server side: .cmd)."""
    fd = os.open(fifo_path + ".cmd", os.O_WRONLY)
    try:
        os.write(fd, f"{int(code)}\n".encode())
    finally:
        os.close(fd)


LEVELS_CYCLE = [9, 10, 11]
MODE_NAMES = ["warp12", "warp21", "blend", "hsv", "grey", "sbs1", "sbs2"]


def run_curses(fifo_path: str):  # pragma: no cover - interactive
    import curses

    def ui(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        levels_i = 0
        white = 255
        msg = ""
        while True:
            try:
                status = read_status(fifo_path, timeout=2.0)
            except (TimeoutError, OSError) as e:
                status = f"(no server: {e})"
            scr.erase()
            scr.addstr(0, 0, f"HopperRender applet -- {fifo_path}")
            for i, line in enumerate(status.splitlines()[:18]):
                scr.addstr(2 + i, 2, line[:100])
            scr.addstr(21, 0, "[a]ctivate [d]eactivate [0-6] mode "
                             "[l]evels [+/-] white [q]uit   " + msg)
            scr.refresh()
            try:
                key = scr.getkey()
            except curses.error:
                continue
            code = None
            if key == "q":
                return
            elif key == "a":
                code = 1
            elif key == "d":
                code = 0
            elif key in "0123456":
                code = 2 + int(key)
                msg = f"mode -> {MODE_NAMES[int(key)]}"
            elif key == "l":
                code = LEVELS_CYCLE[levels_i % 3]
                levels_i += 1
            elif key == "+":
                white = min(white + 5, 255)
                code = 400 + white
            elif key == "-":
                white = max(white - 5, 0)
                code = 400 + white
            if code is not None:
                try:
                    send_code(fifo_path, code)
                    msg = f"sent {code}"
                except OSError as e:
                    msg = f"send failed: {e}"

    import curses
    curses.wrapper(ui)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="terminal client for the HopperRender settings-applet "
                    "protocol")
    p.add_argument("fifo", help="status FIFO path (server's --applet-fifo)")
    p.add_argument("--once", action="store_true",
                   help="print one status block and exit")
    p.add_argument("--send", type=int, default=None, metavar="CODE",
                   help="send one command code and exit")
    args = p.parse_args(argv)
    if args.send is not None:
        send_code(args.fifo, args.send)
        return 0
    if args.once:
        print(read_status(args.fifo))
        return 0
    run_curses(args.fifo)
    return 0


if __name__ == "__main__":
    sys.exit(main())
