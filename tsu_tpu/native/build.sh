#!/bin/sh
# Build the native graph-tools shared library next to this script (a
# git-ignored build output). The library is written under a temporary name
# and renamed, so concurrent first-use builds never load a partial file.
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -shared -fPIC -o "libgraph_tools.so.$$" graph_tools.cpp
mv -f "libgraph_tools.so.$$" libgraph_tools.so
echo "built $(pwd)/libgraph_tools.so"
