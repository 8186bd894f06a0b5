"""Version stamp.

Analogue of reference ``version/version.go:15-19`` (``Version = "0.3.0+git"``).
"""

VERSION = "0.1.0"
GIT_SHA = "dev"
