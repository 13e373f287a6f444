import logging


def load(path):
    try:
        return open(path).read()
    except OSError:
        pass
    except Exception as e:
        logging.getLogger(__name__).warning("cannot load %s: %s", path, e)
