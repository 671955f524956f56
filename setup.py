"""Build the native host data-path extension.

    python setup.py build_ext --inplace
"""

from setuptools import Extension, setup

setup(
    name="mpv_frame_interpolator",
    version="0.1.0",
    packages=["mpv_frame_interpolator"],
    ext_modules=[
        Extension(
            "mpv_frame_interpolator._mfi_native",
            sources=["mpv_frame_interpolator/native/repack.cpp",
                     "mpv_frame_interpolator/native/jpeg.cpp",
                     "mpv_frame_interpolator/native/utvideo.cpp",
                     "mpv_frame_interpolator/native/ffv1.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-Wall", "-pthread"],
            extra_link_args=["-pthread"],
            language="c++",
        )
    ],
)
