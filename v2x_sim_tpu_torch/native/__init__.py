"""Native (C++) host components. See loader.py for the threaded .pcd.bin reader."""
