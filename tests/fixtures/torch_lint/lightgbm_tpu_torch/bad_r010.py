def load(path):
    try:
        return open(path).read()
    except Exception:                          # R010
        pass
