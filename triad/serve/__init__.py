from triad.serve.export import ServingBundle, export_bundle
from triad.serve.server import make_server

__all__ = ["ServingBundle", "export_bundle", "make_server"]
