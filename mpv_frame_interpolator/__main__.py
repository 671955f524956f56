from mpv_frame_interpolator.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
