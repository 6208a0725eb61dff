"""Grand-challenge style deploy wrapper (`deploy/process.py`)."""
