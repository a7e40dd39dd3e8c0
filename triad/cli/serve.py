"""Serve an exported bundle over HTTP (see serve/server.py for the
endpoint contract).

  python -m triad.cli.serve --bundle ./bundle --port 8080
"""

from triad.serve.server import main

if __name__ == "__main__":
    main()
